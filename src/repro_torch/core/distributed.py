"""Multi-device overlay execution over ``torch.distributed``: the Hoplite
torus tiled over a 2-D mesh of devices.

The per-PE layout of :mod:`repro_torch.core.overlay` makes every per-cycle
update local to a PE row, so each rank runs the single-device cycle on its
own ``[nx/nsx, ny/nsy]`` tile of the PE grid: the torus link shifts become a
local roll plus an exchange of the tile's edge with the next rank along the
axis (a halo send and receive: a NoC hop across a tile boundary), and the
termination predicate and the stat counters are reduced over the mesh.

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose two
dims are named ``("data", "model")``, the counterpart of the reference's
``jax.sharding.Mesh``: ``"data"`` tiles ``nx``, ``"model"`` tiles ``ny``.
Every rank calls :func:`repro_torch.run` (``mesh=``) with the whole
``GraphMemory`` and slices its own tile, as the reference's ``in_specs``
do; every rank gets back the same ``SimResult``, values and traces
gathered, as the reference's ``out_specs=P()`` gives.

The stepping is chunked (``cfg.check_every``; 32 by default on a mesh of
more than one device): inside a chunk every predicate and stat stays
tile-local, and the reduce runs once a chunk, on the stacked done trace and
on the stat deltas; the tail under a chunk reduces every cycle. Every branch
the host takes reads only ``done`` and ``cycle`` after a reduce, which are
the same on every rank, so the ranks make the same collectives in the same
order.

Transport, picked from the process group's backend (:func:`route`): under
gloo with tiles on a CUDA device, the halo edges and the reduced tensors
are staged through pinned host buffers (gloo's point-to-point ops take host
memory); under NCCL device tensors go directly; on the CPU host tensors go
directly. On a 1x1 mesh the tile is the whole grid and the reduce is the
identity: no collective is launched, and the chunk is the single-device
engine's (see :func:`_mk_chunk`).

:data:`stats` counts the collectives (halo exchanges, reduces, gathers) and
the host seconds spent in halo exchanges since :func:`reset_stats`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..api import resolve_device
from . import bitvec, overlay, schedulers
from .partition import GraphMemory

#: Collectives launched since :func:`reset_stats` (``halo``: one torus
#: shift's edge exchange; ``all_reduce``: one reduce along one axis, so a
#: reduce over a 2x2 mesh is two; ``all_gather``: one leaf gathered along
#: one axis), and ``halo_s``, the host seconds of the halo exchanges.
stats: dict = {"halo": 0, "all_reduce": 0, "all_gather": 0, "halo_s": 0.0}


def reset_stats() -> None:
    stats.update(halo=0, all_reduce=0, all_gather=0, halo_s=0.0)


class _Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    size: int
    index: int           # this rank's coordinate along the axis
    group: object        # the axis's process group
    ranks: tuple         # global ranks along the axis, by coordinate

    @property
    def nxt(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


def _mesh_axes(mesh, axis_x: str, axis_y: str, nx: int, ny: int):
    """The two axes of ``mesh`` (``axis_x`` tiles ``nx``, ``axis_y``
    tiles ``ny``), checked against the grid."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if len(names) != 2 or {axis_x, axis_y} != set(names):
        raise ValueError(
            f"mesh must be a 2-D torch DeviceMesh with dims named "
            f"{(axis_x, axis_y)}, got dims {names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    grid = mesh.mesh
    axes = []
    for name in (axis_x, axis_y):
        d = names.index(name)
        line = [slice(None)] * 2
        line[1 - d] = coord[1 - d]
        axes.append(_Axis(mesh.size(d), coord[d], mesh.get_group(d),
                          tuple(grid[tuple(line)].tolist())))
    ax, ay = axes
    if nx % ax.size or ny % ay.size:
        raise ValueError(
            f"the {nx}x{ny} PE grid does not tile over the mesh: nx must "
            f"divide by mesh axis {axis_x!r} ({ax.size}) and ny by "
            f"{axis_y!r} ({ay.size})")
    return ax, ay


def _staged(axis: _Axis, device: torch.device) -> bool:
    """Whether this axis's collectives stage device tensors through pinned
    host memory: gloo takes host memory."""
    return device.type == "cuda" and dist.get_backend(axis.group) == "gloo"


def route(mesh, device=None) -> str:
    """How this rank's collectives travel on ``mesh`` for tiles on
    ``device`` (``None`` = the card): the backend and the transport."""
    device = resolve_device(device)
    if mesh.size() == 1:
        return "none (1x1 mesh: local rolls, no collective)"
    backend = dist.get_backend(mesh.get_group(0))
    if device.type == "cuda":
        how = "pinned host buffers" if backend == "gloo" else "device tensors"
    else:
        how = "host tensors"
    return f"{backend}, {how}"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of device tensor ``t`` (the copy completes before
    this returns)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _shard_shift(axis: _Axis, dim: int, device: torch.device):
    """Torus shift by +1 along tensor dim ``dim`` of a ``[6, nx, ny]`` packet
    tile, where that grid axis is tiled ``axis.size`` ways: a local roll,
    then the edge slice goes to the next rank along the axis (the wrap-around
    is the torus link). After the local roll, the tile's row 0 holds its old
    last row, exactly the edge owed to the next rank; every rank receives its
    predecessor's edge into row 0. On an axis of size 1 it is the plain
    roll."""
    if axis.size == 1:
        return lambda p: torch.roll(p, 1, dims=dim)
    staged = _staged(axis, device)
    pinned = []     # the staged path's send and receive buffers

    def shift(p):
        rolled = torch.roll(p, 1, dims=dim)
        edge = rolled.narrow(dim, 0, 1)
        if staged:
            # The halo's time starts when the cycle's work is done. The
            # receive buffer's copy to the card from the last call has
            # completed by then too, so the buffers can be reused.
            torch.cuda.current_stream(device).synchronize()
            if not pinned:
                pinned.extend(torch.empty(edge.shape, dtype=edge.dtype,
                                          pin_memory=True) for _ in range(2))
        t = time.perf_counter()
        if staged:
            send, recv = pinned
            send.copy_(edge)
        else:
            send = edge.contiguous()
            recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, axis.nxt, axis.group),
                dist.P2POp(dist.irecv, recv, axis.prev, axis.group)]):
            work.wait()
        edge.copy_(recv, non_blocking=staged)
        stats["halo"] += 1
        stats["halo_s"] += time.perf_counter() - t
        return rolled

    return shift


def _mk_all_reduce(axes, device: torch.device):
    """The reduce over the mesh: SUM, and MIN over int32 for bool (a logical
    AND across tiles); one collective for each axis of more than one rank.
    ``None`` (the identity) where every axis has one rank."""
    live = [a for a in axes if a.size > 1]
    if not live:
        return None
    staged = _staged(live[0], device)

    def all_reduce(x):
        is_bool = x.dtype == torch.bool
        op = dist.ReduceOp.MIN if is_bool else dist.ReduceOp.SUM
        y = x.to(torch.int32) if is_bool else x.clone()
        buf = _host(y) if staged else y
        for a in live:
            dist.all_reduce(buf, op=op, group=a.group)
            stats["all_reduce"] += 1
        if staged:
            y.copy_(buf)
        return y.to(torch.bool) if is_bool else y

    return all_reduce


def _gather(t: torch.Tensor, axis: _Axis, dim: int) -> torch.Tensor:
    """Tiles of ``t`` along ``axis``, concatenated in coordinate order along
    ``dim``. Under gloo a device tensor is gathered on the host."""
    if axis.size == 1:
        return t
    if _staged(axis, t.device):
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    stats["all_gather"] += 1
    return torch.cat([parts[dist.get_group_rank(axis.group, r)]
                      for r in axis.ranks], dim=dim)


def _gather_telem(telem: dict, ax: _Axis, ay: _Axis) -> dict:
    """Reassemble tile-local telemetry traces into the global PE grid.

    Every telemetry leaf keeps its grid dims as the LAST TWO axes (bucketed
    traces are [NB, nx, ny], per-PE totals [nx, ny]; the batched engine adds
    a leading config axis), so one gather per mesh axis, y then x, rebuilds
    the global trace; accumulation is purely PE-local, so the gathered result
    is bit-identical to a single-device run."""
    return {k: _gather(_gather(v, ay, v.dim() - 1), ax, v.dim() - 2)
            for k, v in telem.items()}


def _gathered(final: dict, ax: _Axis, ay: _Axis) -> dict:
    """The leaves a result reads, the same on every rank: values and traces
    gathered, ``cycle``, ``done`` and the stat counters as the reduces left
    them."""
    d = final["value"].dim() - 3          # 1 for a batched state
    out = {k: final[k] for k in ("cycle", "done", *overlay.STAT_COUNTERS)}
    out["value"] = _gather(_gather(final["value"], ay, d + 1), ax, d)
    if "telem" in final:
        out["telem"] = _gather_telem(final["telem"], ax, ay)
    return out


def _tile_graph(gm: GraphMemory, ax: _Axis, ay: _Axis,
                device) -> overlay.DeviceGraph:
    """This rank's ``[nx/nsx, ny/nsy]`` tile of the graph tables, on
    ``device``."""
    full = overlay.device_graph(gm, "cpu")
    nxl, nyl = gm.nx // ax.size, gm.ny // ay.size
    x0, y0 = ax.index * nxl, ay.index * nyl
    return overlay.DeviceGraph({
        k: v[x0:x0 + nxl, y0:y0 + nyl].contiguous().to(device)
        for k, v in full.items()})


def _mk_chunk(g, cfg, K, cycle_fn, all_reduce, nsx, nsy, *, names=None,
              max_cycles=None):
    """Per-tile chunk step honoring ``cfg.engine``.

    The megakernel chunk (one kernel launch per K cycles over a whole grid)
    cannot contain the halo exchange a sharded torus shift needs, so it only
    engages when both mesh axes are size 1: the shifts are then local rolls,
    the tile IS the grid (x0 = y0 = 0) and the reduce is the identity. On a
    multi-shard mesh ``engine="megakernel"`` runs the tensor chunk (whose
    cycle picks as ``"tensor"`` does), as the reference specifies, with its
    once-per-chunk reduce. Under ``"tensor"`` and ``"select"`` a 1x1 mesh
    runs the single-device chunk (a captured ``ReplayedChunk`` on the
    card); a multi-shard mesh runs the chunk eagerly, since its cycles
    exchange halos through the host (see
    :func:`overlay.make_engine_chunk_fn`)."""
    if cfg.engine == "megakernel" and nsx * nsy > 1:
        cfg = dataclasses.replace(cfg, engine="tensor")
    return overlay.make_engine_chunk_fn(g, cfg, K, cycle_fn=cycle_fn,
                                        names=names, max_cycles=max_cycles,
                                        all_reduce=all_reduce)


def _run_tile(g, cfg, state, gm: GraphMemory, ax: _Axis, ay: _Axis,
              budget: list, names=None) -> dict:
    """Advance this rank's tile ``state`` (solo, or batched over the member
    policies ``names``) until every element is done or at its budget."""
    nxl, nyl, L = g["opcode"].shape
    dev = g["opcode"].device
    K = overlay.resolve_check_every(cfg, gm.nx, gm.ny, L,
                                    device_type=dev.type,
                                    num_devices=ax.size * ay.size)
    all_reduce = _mk_all_reduce((ay, ax), dev)
    sched = schedulers.BatchedScheduler(names) if names else None

    def mk_cycle(reduce):
        return overlay.make_cycle_fn(
            g, cfg, scheduler=sched, shift_e=_shard_shift(ax, 1, dev),
            shift_s=_shard_shift(ay, 2, dev), all_reduce=reduce,
            x0=ax.index * nxl, y0=ay.index * nyl, global_ny=gm.ny)

    mega = cfg.engine == "megakernel" and all_reduce is None
    cycle_fn = None if mega else mk_cycle(None)

    def chunk_of(k, **kw):
        return _mk_chunk(g, cfg, k, cycle_fn, all_reduce, ax.size, ay.size,
                         names=names, **kw)

    chunk = chunk_of(K) if K > 1 or cfg.engine == "megakernel" else None
    if names is not None:
        step = chunk_of(1, max_cycles=torch.tensor(budget, dtype=torch.int32,
                                                   device=dev))
    else:
        step = chunk_of(1) if mega else mk_cycle(all_reduce)
    return overlay._drive(state, chunk, step, K, 2 if mega else 1, budget)


@torch.inference_mode()
def _simulate_sharded(gm, mesh, cfg: overlay.OverlayConfig | None = None,
                      axis_x: str = "data", axis_y: str = "model",
                      nx: int | None = None, ny: int | None = None, *,
                      device=None) -> overlay.SimResult:
    """Run the overlay with the PE grid tiled over ``mesh`` (behind
    :func:`repro_torch.run` with ``mesh=``).

    nx must divide by the mesh's ``axis_x`` size, ny by its ``axis_y``
    size. Returns the same SimResult as a single-device run, on every rank.
    Accepts a packed :class:`GraphMemory` or a raw ``DataflowGraph`` plus
    ``nx``/``ny`` (placed per ``cfg.placement``, on every rank alike). The
    tile lives on ``device`` (``None`` = this rank's current CUDA device).
    """
    cfg = cfg or overlay.OverlayConfig()
    device = resolve_device(device)
    gm = overlay._as_memory(gm, cfg, nx, ny, device)
    ax, ay = _mesh_axes(mesh, axis_x, axis_y, gm.nx, gm.ny)
    g = _tile_graph(gm, ax, ay, device)
    final = _run_tile(g, cfg, overlay.init_state(g, cfg), gm, ax, ay,
                      [cfg.max_cycles])
    return overlay._unpack_result(_gathered(final, ax, ay), gm, cfg=cfg)


def simulate_sharded(gm, mesh, cfg: overlay.OverlayConfig | None = None,
                     axis_x: str = "data", axis_y: str = "model",
                     nx: int | None = None, ny: int | None = None, *,
                     device=None):
    """DEPRECATED: use :func:`repro_torch.run` with ``mesh=mesh``."""
    warnings.warn(
        "distributed.simulate_sharded is deprecated; use "
        "repro_torch.run(gm, cfg, mesh=mesh, nx=, ny=)",
        DeprecationWarning, stacklevel=2)
    return _simulate_sharded(gm, mesh, cfg, axis_x, axis_y, nx, ny,
                             device=device)


@torch.inference_mode()
def _simulate_batch_sharded(gm, mesh, cfgs, axis_x: str = "data",
                            axis_y: str = "model", nx: int | None = None,
                            ny: int | None = None, *,
                            device=None) -> list[overlay.SimResult]:
    """Multi-config sweep of a sharded overlay: the batched engine on each
    tile (behind :func:`repro_torch.run` with ``mesh=`` and ``batch=``).

    The configs may vary in scheduler, select latency and cycle budget;
    ``eject_capacity``, ``eject_policy``, ``engine``, ``placement`` and
    ``telemetry`` must be uniform. The once-per-chunk reduce covers the
    whole batch (the ``[K, B]`` done trace, the ``[B]`` stat deltas).
    Results are element-wise identical to serial sharded runs, and to
    single-device runs.
    """
    cfgs = list(cfgs)
    if not cfgs:
        return []
    eject = {c.eject_capacity for c in cfgs}
    if len(eject) != 1:
        raise ValueError(
            f"simulate_batch_sharded needs a uniform eject_capacity, got {eject}")
    policy = {c.eject_policy for c in cfgs}
    if len(policy) != 1:
        raise ValueError(
            f"simulate_batch_sharded needs a uniform eject_policy, got {policy}")
    engines = {c.engine for c in cfgs}
    if len(engines) != 1:
        raise ValueError(
            f"simulate_batch_sharded needs a uniform engine "
            f"('tensor' | 'select' | 'megakernel'), got {engines}")
    placements = {c.placement for c in cfgs}
    if len(placements) != 1:
        raise ValueError(
            f"simulate_batch_sharded needs a uniform placement, got {placements}")
    telems = {c.telemetry for c in cfgs}
    if len(telems) != 1:
        raise ValueError(
            f"simulate_batch_sharded needs a uniform telemetry spec (it "
            f"shapes the traced state), got {telems}")
    if not isinstance(gm, GraphMemory):
        # One packed memory image serves the batch (see overlay's batch).
        wants = {schedulers.get(c.scheduler).wants_criticality_order
                 for c in cfgs}
        if len(wants) != 1:
            raise ValueError(
                "simulate_batch_sharded over a raw DataflowGraph needs "
                "schedulers with a uniform wants_criticality_order; group "
                "configs by memory layout or pass a pre-built GraphMemory")
    device = resolve_device(device)
    gm = overlay._as_memory(gm, cfgs[0], nx, ny, device)
    ax, ay = _mesh_axes(mesh, axis_x, axis_y, gm.nx, gm.ny)
    names = tuple(dict.fromkeys(c.scheduler for c in cfgs))
    base = dataclasses.replace(cfgs[0], scheduler=names[0],
                               select_latency=None,
                               max_cycles=max(c.max_cycles for c in cfgs))
    g = _tile_graph(gm, ax, ay, device)
    num_words = g["opcode"].shape[2] // bitvec.FLAGS_PER_WORD
    state = overlay.init_batch_state(
        g, base, names, [names.index(c.scheduler) for c in cfgs],
        [schedulers.get(c.scheduler).sel_lat(c, num_words) for c in cfgs])
    final = _run_tile(g, base, state, gm, ax, ay,
                      [c.max_cycles for c in cfgs], names)
    out = _gathered(final, ax, ay)
    return [overlay._unpack_result(out, gm, b, cfg=base)
            for b in range(len(cfgs))]


def simulate_batch_sharded(gm, mesh, cfgs, axis_x: str = "data",
                           axis_y: str = "model", nx: int | None = None,
                           ny: int | None = None, *, device=None):
    """DEPRECATED: use :func:`repro_torch.run` with ``mesh=mesh,
    batch=cfgs``."""
    warnings.warn(
        "distributed.simulate_batch_sharded is deprecated; use "
        "repro_torch.run(gm, mesh=mesh, batch=cfgs, nx=, ny=)",
        DeprecationWarning, stacklevel=2)
    return _simulate_batch_sharded(gm, mesh, cfgs, axis_x, axis_y, nx, ny,
                                   device=device)
