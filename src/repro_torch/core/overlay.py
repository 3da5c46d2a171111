"""Cycle-accurate token-dataflow overlay simulator (paper §II), in torch.

A simulation is a loop of one-cycle transitions that advance every PE and
every Hoplite router together. All per-cycle updates are local to a PE row
(the paper's "local graph memory"). The engine runs eagerly on one torch
device; it reproduces the reference package's single-device engine bit for
bit: cycle counts, stat counters, node values and every state leaf. The same
cycle and chunks step one tile of a grid sharded over a mesh
(:mod:`repro_torch.core.distributed`), through their torus-shift and
reduce hooks.

Timing model (faithful to §II):
  * one packet ejected per PE per cycle, one packet injected per PE per cycle
    (subject to NoC arbitration);
  * ALU latency 1 cycle (single-stage pipelined DSP), folded into fire;
  * scheduler select latency: policy-dependent exposed cycles (see
    ``OverlayConfig.select_latency`` and each policy's ``sel_lat``);
  * Hoplite: 1 cycle per hop, deflection on contention.

Engines (``OverlayConfig.engine``), identical in what they compute:
  * ``"select"`` (default): the scheduler pick and RDY clear go through the
    hand-written leading-one kernels of :mod:`repro_torch.kernels.lod`;
  * ``"tensor"``: the same cycle with the pick as plain tensor ops (the
    reference's ``"jnp"`` engine; ``engine="jnp"`` names it too);
  * ``"megakernel"``: each K-cycle chunk is one launch of the hand-written
    kernel of :mod:`repro_torch.kernels.megakernel` on a CUDA state, the
    ``"tensor"`` chunk on a CPU state.

Chunked stepping: ``check_every`` cycles run back to back between two reads
of ``done`` by the host. A completed overlay is a fixed point of the cycle
function, so cycles simulated past completion change nothing but the cycle
counter, which is repaired from the chunk's per-cycle done trace
(:func:`make_chunk_fn`). Results are bit-identical for every ``check_every``.
On the card the ``"tensor"`` and ``"select"`` engines replay each whole
chunk as one captured CUDA graph (:class:`ReplayedChunk`), the port's
counterpart of the reference's jitted scan, and run their tail eagerly.
Under ``"megakernel"`` the host enqueues the next chunk before it reads the
last one's ``done``, where the budget allows both, so the card need not wait
on the host between chunks; such a queued chunk leaves the state as it is
where it finds every element done, as no chunk would have run there.

The cycle updates the state's slot planes (``pending``, ``operands``,
``value``, ``computed``) and its trace leaves (``telem``, where the config
carries a ``TelemetrySpec``) in place, and the megakernel every state
tensor; :func:`init_state` allocates them fresh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..api import resolve_device
from ..place import spec as place_spec
from ..telemetry import result as telemetry_result
from ..telemetry import trace as telemetry_trace
from ..telemetry.spec import TelemetrySpec
from . import bitvec, noc, schedulers
from .graph import DIV_EPS, OP_ADD, OP_DIV, OP_MUL, OP_SUB, DataflowGraph
from .partition import GraphMemory
from .schedulers import row_gather as _row_gather

#: Chunk execution engines (cycle-exact by construction, see OverlayConfig).
ENGINES = ("tensor", "select", "megakernel")
#: Other names of the engines: the reference's name of the ``"tensor"`` cycle.
ENGINE_ALIASES = {"jnp": "tensor"}


def alu(opcode, a, b):
    """Vectorized ALU — identical semantics to graph.apply_op (f32).

    The divide is ``a / (b +- DIV_EPS)`` in IEEE float32; torch's ``/`` is
    correctly rounded on the CPU and on CUDA (no fast math anywhere). The
    Python-float constants round to float32, as the reference's do."""
    safe_b = b + torch.where(b >= 0, DIV_EPS, -DIV_EPS)
    return torch.where(
        opcode == OP_ADD, a + b, torch.where(
            opcode == OP_SUB, a - b, torch.where(
                opcode == OP_MUL, a * b, torch.where(
                    opcode == OP_DIV, a / safe_b, 0.0))))


@dataclasses.dataclass(frozen=True)
class OverlayConfig:
    """Simulation knobs, as in the reference package's ``OverlayConfig``.

    ``select_latency`` models the scheduler pick cost in *exposed* cycles;
    ``None`` defers to the policy's default (1 for ``ooo``/``inorder``/
    ``lru_flat``; the RDY word count for ``scan``).

    ``check_every`` is an engine knob, not a model knob: cycles per host read
    of the termination flag. ``None`` autotunes (see
    :func:`resolve_check_every`); every value gives bit-identical results.

    ``eject_policy`` (``"n_first"`` | ``"priority"``) and ``eject_capacity``
    (1 | 2) ARE model knobs: see :func:`repro_torch.core.noc.router_cycle`.

    ``telemetry`` is a :class:`repro_torch.telemetry.TelemetrySpec` (trace
    leaves under ``state["telem"]``, a ``TelemetryResult`` on each result)
    or ``None`` (tracing off). ``engine`` also takes the reference's
    ``"jnp"``, stored as ``"tensor"``.

    ``placement`` names how nodes map onto the PE grid when a run is handed
    a raw :class:`~repro_torch.core.graph.DataflowGraph`: a strategy name
    (static or search), a :class:`repro_torch.place.PlacementSpec`, or an
    explicit ``[N]`` node -> PE array, normalised as the reference
    normalises them (two spellings of one layout compare and hash equal).
    ``None``, ``"identity"`` and the default spec are the identity
    placement, stored as :data:`repro_torch.place.spec.IDENTITY` as the
    reference stores it; any other name or spec is stored as its spec, an
    array as a hashable
    :class:`~repro_torch.place.spec.PlacementArray`. Ignored when the run
    is handed a packed :class:`GraphMemory`.
    """

    scheduler: str = "ooo"           # any name in schedulers.REGISTRY
    select_latency: int | None = None  # exposed cycles; None = policy default
    eject_capacity: int = 1          # 2 == paper §II-C BRAM multipumping
    max_cycles: int = 1_000_000
    check_every: int | None = None   # cycles per termination check; None=auto
    eject_policy: str = "n_first"    # NoC eject arbitration (see noc.py)
    placement: Any = None            # PlacementSpec | name | [N] array | None
    #: "select" (leading-one kernels per cycle), "tensor" (plain tensor
    #: ops; "jnp" names it too) or "megakernel" (one kernel launch per
    #: K-cycle chunk).
    engine: str = "select"
    telemetry: Any = None            # TelemetrySpec | None = tracing off

    def __post_init__(self):
        engine = ENGINE_ALIASES.get(self.engine, self.engine)
        if engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES} (or {tuple(ENGINE_ALIASES)}"
                f"), got {self.engine!r}")
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "placement", _placement(self.placement))
        if self.telemetry is not None and not isinstance(self.telemetry,
                                                         TelemetrySpec):
            raise TypeError(
                f"telemetry must be a repro_torch.telemetry.TelemetrySpec or "
                f"None, got {type(self.telemetry).__name__}")
        if self.select_latency is not None and self.select_latency < 1:
            raise ValueError(
                f"select_latency must be >= 1 exposed cycle (or None for the "
                f"policy default), got {self.select_latency}")
        if self.check_every is not None and self.check_every < 1:
            raise ValueError(
                f"check_every must be >= 1 cycle per termination check (or "
                f"None to autotune), got {self.check_every}")
        if self.eject_policy not in ("n_first", "priority"):
            raise ValueError(
                f"eject_policy must be 'n_first' or 'priority', got "
                f"{self.eject_policy!r}")
        schedulers.get(self.scheduler)  # validate early

    @property
    def sel_lat(self) -> int:
        return 1 if self.select_latency is None else self.select_latency


def _placement(placement):
    """``OverlayConfig.placement``'s stored form: the canonical spec
    (``IDENTITY`` for the identity spellings) or a :class:`PlacementArray`."""
    if isinstance(placement, place_spec.PlacementArray):
        return placement
    if isinstance(placement, np.ndarray):
        return place_spec.PlacementArray(placement)
    spec = place_spec.resolve(placement)
    return place_spec.IDENTITY if spec == place_spec.IDENTITY else spec


def resolve_check_every(cfg: OverlayConfig, nx: int, ny: int, L: int, *,
                        device_type: str = "cpu", num_devices: int = 1) -> int:
    """Cycles per chunk. Any value is cycle-exact; the autotune only trades
    the per-chunk host read of ``done`` against wasted tail cycles (up to
    K-1 extra cycle evaluations after completion):

      * always 32 on a mesh of more than one device (``num_devices``),
        where the chunk also amortizes its reduce over the mesh;
      * grows with the slot count: 8 / 16 / 32;
      * at least 16 on CUDA, where each read of ``done`` synchronises the
        host with the device, and under ``engine="select"``;
      * always 32 under ``engine="megakernel"``: one launch per chunk, so
        the launch amortizes with depth whatever the graph size.
    """
    if cfg.check_every is not None:
        return cfg.check_every
    if num_devices > 1 or cfg.engine == "megakernel":
        return 32
    slots = nx * ny * L
    base = 8 if slots <= 4_096 else (16 if slots <= 65_536 else 32)
    if cfg.engine == "select" or device_type == "cuda":
        base = max(base, 16)
    return base


class DeviceGraph(dict):
    """GraphMemory as torch tensors reshaped to [nx, ny, ...]."""


def device_graph(gm: GraphMemory, device=None) -> DeviceGraph:
    """Move ``gm`` onto ``device`` (``None`` = the CUDA card; raises without
    one). The simulation runs on the device its graph is on."""
    nx, ny = gm.nx, gm.ny
    device = resolve_device(device)

    def r3(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(nx, ny, -1)
        return t.to(device=device, dtype=dtype or t.dtype)

    return DeviceGraph(
        opcode=r3(gm.opcode, torch.int32),
        fanin=r3(gm.fanin, torch.int32),
        init_value=r3(gm.init_value),
        fo_base=r3(gm.fo_base, torch.int32),
        fo_count=r3(gm.fo_count, torch.int32),
        valid=r3(gm.valid),
        e_dst_pe=r3(gm.e_dst_pe, torch.int32),
        e_dst_slot=r3(gm.e_dst_slot, torch.int32),
        e_dst_opidx=r3(gm.e_dst_opidx, torch.int32),
    )


# ---------------------------------------------------------------------------
# Stat-counter registry: monotone int32 0-dim counters in the state, zero at
# init, incremented by the cycle. A completed overlay is a fixed point of the
# cycle, so every counter's increment is zero once ``done`` holds; that is
# what lets the chunk engine run past completion without drift.
# ---------------------------------------------------------------------------

STAT_COUNTERS: dict[str, str] = {}


def register_counter(name: str, doc: str = "") -> None:
    """Add a monotone 0-dim int32 stat counter to the state."""
    if name in STAT_COUNTERS:
        raise ValueError(f"duplicate stat counter {name!r}")
    STAT_COUNTERS[name] = doc


for _name, _doc in (
    ("delivered", "packets ejected into a PE's local memory"),
    ("noc_deflections", "route-contention deflections: in-flight S-turn "
     "losers plus blocked PE injections (away from the destination)"),
    ("eject_deflections", "eject-port losers at the destination router, "
     "sent around the ring again"),
    ("deflections", "noc_deflections + eject_deflections"),
    ("busy_cycles", "node fires summed over PEs and cycles"),
):
    register_counter(_name, _doc)


def _resolve(cfg: OverlayConfig, scheduler):
    return scheduler if scheduler is not None else schedulers.get(cfg.scheduler)


def init_state(g: DeviceGraph, cfg: OverlayConfig, *, scheduler=None):
    """Policy-agnostic simulation state, keyed as the reference's state.
    Scheduler state lives under ``state["sched"]``; packets on the links are
    [6, nx, ny] tensors (:mod:`repro_torch.core.noc`). ``scheduler``
    overrides ``cfg.scheduler`` (the batched engine's composite policy).
    With ``cfg.telemetry`` the trace leaves of that spec ride under
    ``state["telem"]`` (:func:`repro_torch.telemetry.trace.init`)."""
    sched = _resolve(cfg, scheduler)
    nx, ny, L = g["opcode"].shape
    dev = g["opcode"].device
    i32 = dict(dtype=torch.int32, device=dev)
    is_input = (g["fanin"] == 0) & g["valid"]
    lat = sched.sel_lat(cfg, L // bitvec.FLAGS_PER_WORD)
    state = dict(
        pending=g["fanin"].clone(),
        operands=torch.zeros((nx, ny, L, 2), dtype=torch.float32, device=dev),
        computed=is_input,
        value=torch.where(is_input, g["init_value"],
                          torch.zeros_like(g["init_value"])),
        remaining=(g["valid"] & ~is_input).sum(dtype=torch.int32),
        sched=sched.init(g, cfg),
        active=torch.full((nx, ny), -1, **i32),
        cursor=torch.zeros((nx, ny), **i32),
        cursor_end=torch.zeros((nx, ny), **i32),
        sel_lat=torch.tensor(lat, **i32),
        sel_wait=torch.full((nx, ny), lat - 1, **i32),
        link_e=noc.empty_packets(nx, ny, device=dev),
        link_s=noc.empty_packets(nx, ny, device=dev),
        cycle=torch.tensor(0, **i32),
        done=torch.tensor(False, device=dev),
        **{k: torch.tensor(0, **i32) for k in STAT_COUNTERS},
    )
    if cfg.telemetry is not None:
        state["telem"] = telemetry_trace.init(cfg.telemetry, nx, ny, dev)
    return state


def make_cycle_fn(g: DeviceGraph, cfg: OverlayConfig, *, scheduler=None,
                  shift_e: Callable = noc.roll_shift_e,
                  shift_s: Callable = noc.roll_shift_s,
                  all_reduce: Callable | None = None, x0: int = 0,
                  y0: int = 0, global_ny: int | None = None):
    """Build the one-cycle transition ``state -> state`` (``scheduler``
    overrides ``cfg.scheduler``).

    On a tile of a grid sharded over a mesh (:mod:`core.distributed`),
    ``shift_e``/``shift_s`` are the torus shifts with the halo exchange,
    ``x0``/``y0`` the tile's global offsets and ``global_ny`` the whole
    grid's ny (edge records name global PEs). ``all_reduce`` reduces the
    termination predicates (a logical AND over the tiles) and the stat
    increments (a sum) over the mesh each cycle; ``None`` is the identity,
    as on one device and inside a chunk (:func:`make_chunk_fn`).

    The tables the cycle reads every time (router coordinates, the edge
    records stacked as packet fields, the fanout base/count pairs, flat slot
    offsets) are built once here. With ``cfg.telemetry`` the cycle also adds
    its increments to the trace leaves (:func:`telemetry_trace.accumulate`),
    in place, from signals it computes anyway; nothing feeds back into the
    model."""
    sched = _resolve(cfg, scheduler)
    nx, ny, L = g["opcode"].shape
    dev = g["opcode"].device
    use_kernels = cfg.engine == "select"
    E = 2 if cfg.eject_capacity >= 2 else 1
    coords = noc.grid_coords(nx, ny, device=dev)
    if x0 or y0:
        coords = (coords[0] + x0, coords[1] + y0)
    gny = ny if global_ny is None else global_ny
    # Edge records as the four routing fields of an injected packet.
    dst_pe = g["e_dst_pe"]
    edge = torch.stack((dst_pe // gny, dst_pe % gny, g["e_dst_slot"],
                        g["e_dst_opidx"]))                 # [4, nx, ny, emax]
    emax = edge.shape[-1]
    fo = torch.stack((g["fo_base"], g["fo_count"]), dim=-1)   # [nx, ny, L, 2]
    # Flat offset of each PE's slot 0 in the [nx, ny, L] planes.
    pe_base = (torch.arange(nx * ny, dtype=torch.int64, device=dev)
               * L).reshape(nx, ny)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    spec = cfg.telemetry

    def cycle(s):
        # ---- 1. offer injection packet from the active node's fanout cursor
        active, cursor = s["active"], s["cursor"]
        inj_valid = (active >= 0) & (cursor < s["cursor_end"])
        cur = cursor.clamp(0, emax - 1).to(torch.int64)
        route = torch.gather(edge, 3, cur[None, :, :, None].expand(4, nx, ny, 1))
        inject = torch.cat((
            inj_valid.to(torch.int32)[None], route[..., 0],
            _row_gather(s["value"], active).view(torch.int32)[None]))

        # ---- 2. NoC cycle
        link_e, link_s, ejects, accepted, deflected = noc.router_cycle(
            s["link_e"], s["link_s"], inject, shift_e=shift_e, shift_s=shift_s,
            eject_capacity=cfg.eject_capacity, eject_policy=cfg.eject_policy,
            coords=coords)

        # ---- 3. advance fanout cursor; retire drained nodes
        cursor = cursor + accepted.to(torch.int32)
        cursor_end = s["cursor_end"]
        drained = (active >= 0) & (cursor >= cursor_end)
        active = torch.where(drained, minus1, active)
        sel_wait = torch.where(drained, s["sel_lat"] - 1, s["sel_wait"])

        # ---- 4. apply ejected packets, fused across the eject ports: one
        # flat scatter per plane. Each (pe, slot, opidx) operand cell
        # receives exactly one packet over the whole run and each slot fires
        # at most once, so the scatter-adds are exact in any order.
        ej = torch.stack(ejects) if E > 1 else ejects[0][None]   # [E, 6, nx, ny]
        ej_valid = ej[:, noc.VALID] != 0
        ej_slot = ej[:, noc.DST_SLOT].clamp(0, L - 1)
        ej_op = ej[:, noc.OPIDX].clamp(0, 1)
        ej_val = ej[:, noc.VALUE].view(torch.float32)
        flat = pe_base + ej_slot                                   # [E, nx, ny]

        operands = s["operands"]
        operands.view(-1).put_(flat * 2 + ej_op,
                               torch.where(ej_valid, ej_val, zero_f),
                               accumulate=True)
        pending = s["pending"]
        pending.view(-1).put_(flat, -ej_valid.to(torch.int32), accumulate=True)

        # A slot fires the cycle a delivery drops its pending count to zero.
        # When two ports hit the same slot in one cycle both see the
        # post-decrement count, and the first port claims the fire.
        computed = s["computed"]
        was_done = computed.view(-1)[flat]
        fired = ej_valid & (pending.view(-1)[flat] == 0) & ~was_done
        if E > 1:
            same = ej_slot[0] == ej_slot[1]
            fired = torch.stack((fired[0], fired[1] & ~(fired[0] & same)))

        opnds = operands.view(-1, 2)[flat]                        # [E, nx, ny, 2]
        fval = alu(g["opcode"].view(-1)[flat], opnds[..., 0], opnds[..., 1])
        value = s["value"]
        value.view(-1).put_(flat, torch.where(fired, fval, zero_f),
                            accumulate=True)
        # Both ports write the same flag when they share a slot.
        done_now = fired if E == 1 else fired | (fired.flip(0) & same)
        computed.view(-1)[flat] = was_done | done_now

        # Enqueue fired nodes in eject-port order (per-PE FIFO arrival order).
        sched_st = s["sched"]
        ready = fired & (g["fo_count"].view(-1)[flat] > 0)
        for e in range(E):
            sched_st = sched.on_ready(sched_st, ej_slot[e], ready[e])

        n_delivered = ej_valid.sum(dtype=torch.int32)
        n_fired = fired.sum(dtype=torch.int32)

        # ---- 5. scheduler: select (and consume) the next node on idle PEs
        idle = active < 0
        gate = idle & (sel_wait == 0)
        if spec is not None and spec.sched:
            # Ready-set depth as the scheduler sees it at pick time: after
            # this cycle's fires enqueued, before the pick consumes.
            rdy_depth = sched.ready_depth(sched_st)
        cand, have, sched_st = sched.step(sched_st, idle, gate,
                                          use_kernels=use_kernels)
        can_wait = idle & have & (sel_wait > 0)
        sel_wait = sel_wait - can_wait.to(torch.int32)
        sel = gate & have

        active = torch.where(sel, cand, active)
        new = _row_gather(fo, cand)                               # [nx, ny, 2]
        cursor = torch.where(sel, new[..., 0], cursor)
        cursor_end = torch.where(sel, new[..., 0] + new[..., 1], cursor_end)

        # ---- 6. termination + stats. ``remaining`` counts uncomputed valid
        # nodes (of this tile), so the all-computed predicate is O(1) per
        # cycle.
        remaining = s["remaining"] - n_fired
        preds = (remaining == 0, sched.empty(sched_st), (active < 0).all(),
                 noc.links_empty(link_e, link_s))

        # A blocked PE injection keeps its packet circulating in the PE just
        # as a lost S-turn keeps it on the ring: both count as NoC
        # deflections; eject-port losers count separately.
        inj_blocked = inj_valid & ~accepted
        d_noc = (inj_blocked.sum(dtype=torch.int32)
                 + deflected["noc"].sum(dtype=torch.int32))
        d_ej = deflected["eject"].sum(dtype=torch.int32)
        if all_reduce is None:
            done = preds[0] & preds[1] & preds[2] & preds[3]
        else:
            done = all_reduce(torch.stack(preds)).all()
            n_delivered, n_fired, d_noc, d_ej = all_reduce(torch.stack(
                (n_delivered, n_fired, d_noc, d_ej))).unbind(0)

        if spec is not None:
            telemetry_trace.accumulate(
                spec, s["telem"], cycle=s["cycle"],
                fired=fired.sum(dim=0, dtype=torch.int32),
                occupied=s["active"] >= 0,
                link_e_busy=link_e[noc.VALID] != 0,
                link_s_busy=link_s[noc.VALID] != 0,
                defl_noc=deflected["noc"] + inj_blocked.to(torch.int32),
                defl_eject=deflected["eject"],
                eject_grant=ej_valid.sum(dim=0, dtype=torch.int32),
                ready_depth=rdy_depth if spec.sched else None,
                sel=sel, cand=cand, no_ready=idle & ~have,
                inj_blocked=inj_blocked, sel_waiting=can_wait)

        out = dict(
            pending=pending, operands=operands, computed=computed, value=value,
            remaining=remaining,
            sched=sched_st,
            active=active, cursor=cursor, cursor_end=cursor_end,
            sel_lat=s["sel_lat"], sel_wait=sel_wait,
            link_e=link_e, link_s=link_s,
            cycle=s["cycle"] + 1,
            delivered=s["delivered"] + n_delivered,
            noc_deflections=s["noc_deflections"] + d_noc,
            eject_deflections=s["eject_deflections"] + d_ej,
            deflections=s["deflections"] + d_noc + d_ej,
            busy_cycles=s["busy_cycles"] + n_fired,
            done=done,
        )
        if spec is not None:
            out["telem"] = s["telem"]
        return out

    return cycle


def repair_telemetry(telem: dict, overshoot) -> None:
    """Undo, in place, the only trace increment that is NOT zero at the
    completed-overlay fixed point: once every PE is idle with an empty ready
    set, ``stall_no_ready`` gains 1 a PE a cycle simulated past completion.
    ``overshoot`` (0-dim) is the chunk's count of such cycles, its end cycle
    less the repaired cycle: 0 while running, K - first - 1 where the run
    completes inside the chunk, K where a done element runs a chunk. Every
    other leaf's increment vanishes at the fixed point. A batch's
    ``overshoot`` is ``[B]``, one an element."""
    if "stall_no_ready" in telem:
        telem["stall_no_ready"].sub_(overshoot.reshape(overshoot.shape
                                                       + (1, 1)))


def _chunk_start(s: dict, all_reduce) -> tuple:
    """What the chunk repair needs of the state a chunk starts from (copies:
    a batched chunk writes each element's cycles into these tensors)."""
    stats = (torch.stack([s[k] for k in STAT_COUNTERS])
             if all_reduce is not None else None)
    return s["cycle"].clone(), s["done"].clone(), stats


def _finish_chunk(s: dict, start: tuple, done_trace, all_reduce):
    """The chunk repair of ``s`` after the chunk's cycles, from the per-cycle
    ``done_trace`` (``[K]``, or ``[K, B]`` over a batched state): with
    ``all_reduce``, first the chunk's one reduce over the mesh of the trace
    (a logical AND over the tiles) and of the stat deltas; then ``done`` and
    the exact completion cycle, and the telemetry repair. Returns
    ``(state, done_trace)``."""
    start_cycle, start_done, start_stats = start
    if all_reduce is not None:
        done_trace = all_reduce(done_trace)
        end = torch.stack([s[k] for k in STAT_COUNTERS])
        stats = start_stats + all_reduce(end - start_stats)
        s = dict(s, **dict(zip(STAT_COUNTERS, stats.unbind(0))))
    any_done = done_trace.any(0)
    first = torch.argmax(done_trace.to(torch.int32), 0).to(torch.int32)
    cycle = torch.where(
        start_done, start_cycle,
        torch.where(any_done, start_cycle + first + 1, s["cycle"]))
    if "telem" in s:
        repair_telemetry(s["telem"], s["cycle"] - cycle)
    return dict(s, done=any_done, cycle=cycle), done_trace


def make_chunk_fn(cycle_fn, check_every: int, all_reduce=None, *,
                  with_trace: bool = False):
    """Wrap ``check_every`` cycles of ``cycle_fn`` into one chunk step.

    The chunk body is guard-free: a completed overlay is a *fixed point* of
    ``cycle_fn`` (no ready nodes, no active fanout drains, empty links), so
    cycles simulated past completion change nothing but the cycle counter,
    which is repaired from the first done entry of the per-cycle trace. Stat
    counters need no repair on one device (their increments vanish at the
    fixed point); the trace leaves of a traced state need one
    (:func:`repair_telemetry`). The ``max_cycles`` budget is enforced by the
    caller: a chunk is entered only while a full chunk fits (see
    :func:`run_state`).

    ``all_reduce`` (a tile of a sharded grid, :mod:`core.distributed`)
    reduces over the mesh once per chunk: ``cycle_fn`` is then built
    without one, so inside the chunk every predicate and stat increment
    stays tile-local, and the stacked done trace (a logical AND) and the
    chunk's stat deltas (``start + all_reduce(end - start)``) are reduced
    before the repair.
    With ``with_trace`` the chunk returns ``(state, done_trace [K])``.
    """

    def chunk(s):
        start = _chunk_start(s, all_reduce)
        trace = []
        for _ in range(check_every):
            s = cycle_fn(s)
            trace.append(s["done"])
        s, done_trace = _finish_chunk(s, start, torch.stack(trace), all_reduce)
        return (s, done_trace) if with_trace else s

    return chunk


def element(state: dict, b: int) -> dict:
    """Batch element ``b`` of a batched state: views ``leaf[b]``, each a
    contiguous tensor in the solo layout, sharing storage with ``state``."""
    return {k: element(v, b) if isinstance(v, dict) else v[b]
            for k, v in state.items()}


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def make_batch_chunk_fn(cycle_fn, check_every: int, *,
                        with_trace: bool = False, max_cycles=None,
                        all_reduce=None):
    """The batched chunk as a loop over the elements: each element's views
    go through ``check_every`` cycles of ``cycle_fn`` (built with the
    :class:`~repro_torch.core.schedulers.BatchedScheduler`), and the leaves
    they return are copied back into the stacked tensors; then the chunk
    repair runs on the batch (:func:`make_chunk_fn`; with ``all_reduce``,
    one reduce of the ``[K, B]`` done trace and one of the stat deltas over
    the mesh). Elements that are done still run whole chunks (their cycle is
    repaired), as the reference's vmapped chunk runs them.

    With ``max_cycles`` (``[B]`` int32) the chunk leaves a halted element
    (done, or at its own budget) untouched, leaf for leaf, and records its
    ``done`` in the trace: the reference's per-cycle freeze of the tail.
    Which elements halted is read on the host from ``done`` and ``cycle``,
    which are the same on every tile of a sharded batch."""

    def batch_chunk(s):
        start = _chunk_start(s, all_reduce)
        halted = None
        if max_cycles is not None:
            halted = (s["done"] | (s["cycle"] >= max_cycles)).tolist()
        traces = []
        for b in range(s["cycle"].shape[0]):
            view = element(s, b)
            if halted is not None and halted[b]:
                traces.append(view["done"].expand(check_every))
                continue
            new, trace = view, []
            for _ in range(check_every):
                new = cycle_fn(new)
                trace.append(new["done"])
            _copy_into(view, new)
            traces.append(torch.stack(trace))
        s, trace = _finish_chunk(s, start, torch.stack(traces, dim=1),
                                 all_reduce)
        return (s, trace) if with_trace else s

    return batch_chunk


def _into_state(chunk):
    """``chunk`` as a step that leaves its result in the tensors of the
    state it is given: it runs ``chunk(s)`` and copies every leaf that comes
    back as a new tensor into the leaf of ``s`` (the cycle updates
    ``pending``, ``operands``, ``computed``, ``value`` and the trace leaves
    under ``telem`` in place already).
    It returns ``s`` itself, with the done trace where ``chunk`` returns
    one: the form a captured CUDA graph replays, since every tensor it
    writes then has a fixed address."""

    def step(s):
        out = chunk(s)
        new, trace = out if isinstance(out, tuple) else (out, None)
        _copy_into(s, new)
        return s if trace is None else (s, trace)

    return step


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _same_leaves(a: dict, b: dict) -> bool:
    return all(_same_leaves(v, b[k]) if isinstance(v, dict) else v is b[k]
               for k, v in a.items())


class ReplayedChunk:
    """A chunk of the ``"tensor"``/``"select"`` cycle on the card, captured
    once as a CUDA graph and replayed at every call: the K cycles' ~175
    device ops a cycle (the leading-one kernels among them) go to the card
    as one graph launch, as the reference's chunk is one jitted scan.

    The first call runs the chunk once eagerly on a clone of the state, on a
    side stream (library set-up and kernel loading stay outside the
    capture; the state itself does not advance), then captures
    ``_into_state(chunk)`` over the state's own tensors (a capture records
    and runs nothing) and replays it. Every call replays the graph. A call
    whose state has other tensors than the captured ones copies its leaves
    into the captured tensors first. The returned state *is* the captured
    tensors, which the next call overwrites: a caller that keeps an older
    state clones it. The graph, its memory pool and the tables it reads (in
    the chunk's closure) live as long as this object.

    The leading-one wrappers count a launch where they launch; the warm-up
    (on a clone, discarded) and the capture (which launches nothing) leave
    :data:`repro_torch.kernels.lod.launches` as they found it, and each
    replay adds the launches the capture recorded, so the counts are the
    launches that ran on the card for the run. A capture or replay that
    fails raises ``RuntimeError`` naming the chunk; there is no eager
    fallback.
    """

    def __init__(self, chunk, label: str):
        self.step = _into_state(chunk)
        self.label = label
        self.graph = None
        self.state = None
        self.out = None
        #: Launches of each leading-one kernel that one replay makes.
        self.per_replay: dict[str, int] = {}
        self.replays = 0

    def _fail(self, what: str, err: Exception):
        raise RuntimeError(f"{what} the {self.label} chunk as a CUDA graph "
                           f"failed: {err}") from err

    def _capture(self, s: dict) -> None:
        from ..kernels import lod

        before = dict(lod.launches)
        try:
            with torch.cuda.device(s["cycle"].device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.step(_clone(s))
                torch.cuda.current_stream().wait_stream(side)
                warm = dict(lod.launches)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = self.step(s)
            self.per_replay = {k: n - warm[k] for k, n in lod.launches.items()
                               if n > warm[k]}
        except Exception as err:
            self._fail("capturing", err)
        finally:
            lod.launches.update(before)
        self.graph, self.state, self.out = graph, s, out

    def __call__(self, s: dict):
        from ..kernels import lod

        if self.graph is None:
            self._capture(s)
        elif not _same_leaves(self.state, s):
            _copy_into(self.state, s)
        try:
            self.graph.replay()
        except Exception as err:
            self._fail("replaying", err)
        self.replays += 1
        for k, n in self.per_replay.items():
            lod.launches[k] += n
        return self.out


def make_engine_chunk_fn(g: DeviceGraph, cfg: OverlayConfig, check_every: int,
                         *, cycle_fn=None, names=None, max_cycles=None,
                         all_reduce=None):
    """Chunk step for ``cfg.engine``, the one dispatch point of the
    engines: ``"megakernel"`` builds the one-launch chunk
    (:mod:`repro_torch.kernels.megakernel`); ``"tensor"`` and ``"select"``
    chain ``cycle_fn`` (built here when not supplied), eagerly on the CPU
    and as a :class:`ReplayedChunk` on the card.

    ``names`` (the member policies) makes the chunk batched: it steps a
    state with a leading config axis (:func:`init_batch_state`), and with
    ``max_cycles`` freezes halted elements (see :func:`make_batch_chunk_fn`);
    that tail step reads the halted flags on the host, so it stays eager.

    ``all_reduce`` makes it the chunk of a tile of a grid sharded over
    several devices (:func:`make_chunk_fn`), which runs eagerly: its
    ``cycle_fn`` exchanges halos through the host every cycle, which a
    captured graph cannot hold. The megakernel steps a whole grid and takes
    no ``all_reduce`` (:func:`repro_torch.core.distributed._mk_chunk` runs
    it on a 1x1 mesh only)."""
    if cfg.engine == "megakernel":
        if all_reduce is not None:
            raise ValueError("the megakernel chunk steps a whole grid on one "
                             "device; it takes no all_reduce")
        from ..kernels import megakernel

        return megakernel.make_mega_chunk_fn(g, cfg, check_every, names=names,
                                             max_cycles=max_cycles)
    if names is None:
        chunk = make_chunk_fn(cycle_fn or make_cycle_fn(g, cfg), check_every,
                              all_reduce)
    else:
        chunk = make_batch_chunk_fn(
            cycle_fn or make_cycle_fn(
                g, cfg, scheduler=schedulers.BatchedScheduler(names)),
            check_every, max_cycles=max_cycles, all_reduce=all_reduce)
    if (g["opcode"].device.type != "cuda" or max_cycles is not None
            or all_reduce is not None):
        return chunk
    return ReplayedChunk(chunk, f"{cfg.engine} {check_every}-cycle"
                         + (f" batched {'+'.join(names)}" if names else ""))


class _DoneReader:
    """The ``done`` flags after each chunk in flight, read in order. On the
    card each lands in a pinned host slot behind a CUDA event, so the host
    reads chunk n's flags while chunk n+1 runs: written there by the chunk
    itself where it takes ``done_to`` (the megakernel), else copied; on the
    CPU a clone."""

    def __init__(self, done: torch.Tensor, depth: int, direct: bool):
        self.device = done.device
        self.queue = []
        self.direct = direct and self.device.type == "cuda"
        if self.device.type == "cuda":
            self.slots = []
            for _ in range(depth):
                host = torch.empty(done.shape, dtype=done.dtype,
                                   pin_memory=True)
                self.slots.append((host, host.numpy().reshape(-1),
                                   torch.cuda.Event()))
            self.next = 0

    def target(self):
        """The pinned slot the next chunk writes its flags into, or None."""
        return self.slots[self.next][0] if self.direct else None

    def push(self, done: torch.Tensor) -> None:
        if self.device.type != "cuda":
            self.queue.append(done.clone())
            return
        host, view, event = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if not self.direct:
            host.copy_(done, non_blocking=True)
        if torch.cuda.current_device() == self.device.index:
            event.record()
        else:
            event.record(torch.cuda.current_stream(self.device))
        self.queue.append((view, event))

    def pop(self) -> list:
        item = self.queue.pop(0)
        if self.device.type != "cuda":
            return item.reshape(-1).tolist()
        view, event = item
        event.synchronize()
        return view.tolist()


def _run_chunks(chunk, state, cycle, done, budget, K: int, depth: int):
    """Whole chunks while some element runs (not done, under its budget) and
    every element that is not done has a full chunk of budget left. With
    ``depth`` 2 the next chunk is enqueued before the host reads the last
    one's ``done``, where every such element's budget allows both. A chunk
    so queued (``queued=True``) leaves the state as it is where it finds
    every element done, where ``depth`` 1 would have stopped: a cycle past
    completion can still turn a -0.0 into +0.0 (each eject port adds +0.0
    to its cell). So the results are those of ``depth`` 1. ``cycle``,
    ``done`` and ``budget`` are lists, one entry per element; returns
    (state, cycle, done)."""
    reader = _DoneReader(state["done"], depth,
                         getattr(chunk, "writes_done", False))
    inflight = 0
    while True:
        while (inflight < depth
               and any(not d and c < m for c, d, m in zip(cycle, done, budget))
               and all(d or c + (inflight + 1) * K <= m
                       for c, d, m in zip(cycle, done, budget))):
            target = reader.target()
            if inflight:      # behind a chunk whose done is not read yet
                state = chunk(state, target, queued=True)
            else:
                state = chunk(state) if target is None else chunk(state,
                                                                  target)
            reader.push(state["done"])
            inflight += 1
        if not inflight:
            return state, cycle, done
        now = reader.pop()
        inflight -= 1
        cycle = [c if d else c + K for c, d in zip(cycle, done)]
        done = now


def _drive(state, chunk, step, K: int, depth: int, budget: list):
    """Advance ``state`` (solo, or batched with one entry of ``budget`` an
    element): whole chunks of ``chunk`` (None: none) while they fit every
    running element's budget (:func:`_run_chunks`, ``depth`` chunks in
    flight), then ``step`` until every element is done or at its budget.
    The host reads ``done`` once per chunk and tail step and counts the
    cycles itself."""
    cycle = state["cycle"].reshape(-1).tolist()
    done = state["done"].reshape(-1).tolist()
    if chunk is not None:
        state, cycle, done = _run_chunks(chunk, state, cycle, done, budget, K,
                                         depth)
    while any(live := [not d and c < m
                       for c, d, m in zip(cycle, done, budget)]):
        state = step(state)
        cycle = [c + 1 if r else c for c, r in zip(cycle, live)]
        done = state["done"].reshape(-1).tolist()
    return state


@dataclasses.dataclass
class SimResult:
    cycles: int
    done: bool
    values: np.ndarray        # [N] node values in global id order
    delivered: int
    deflections: int          # noc_deflections + eject_deflections
    busy_cycles: int
    noc_deflections: int = 0
    eject_deflections: int = 0
    #: :class:`repro_torch.telemetry.TelemetryResult` when the config carried
    #: a ``TelemetrySpec``, else None.
    telemetry: Any = None


@torch.inference_mode()
def run_state(g: DeviceGraph, cfg: OverlayConfig, state: dict) -> dict:
    """Advance ``state`` until done or ``cfg.max_cycles``: full chunks while
    one fits the budget, then cycle by cycle. The host reads ``done`` once
    per chunk (and once per tail cycle). On the card the ``"tensor"`` and
    ``"select"`` chunks are replays of one captured graph
    (:class:`ReplayedChunk`) that write into ``state``'s own tensors.

    The megakernel engine keeps one chunk queued: it enqueues chunk n+1
    before it reads chunk n's ``done``, while ``cycle + 2K`` fits the budget
    (see :func:`_run_chunks`). It chunks even at K=1 and runs its tail as
    chunks of one cycle, so every cycle of its run goes through its kernel
    on the card; a chunk of one cycle is that cycle, bit for bit."""
    nx, ny, L = g["opcode"].shape
    K = resolve_check_every(cfg, nx, ny, L, device_type=g["opcode"].device.type)
    mega = cfg.engine == "megakernel"
    cycle_fn = None if mega else make_cycle_fn(g, cfg)
    chunk = (make_engine_chunk_fn(g, cfg, K, cycle_fn=cycle_fn)
             if K > 1 or mega else None)
    step = make_engine_chunk_fn(g, cfg, 1) if mega else cycle_fn
    return _drive(state, chunk, step, K, 2 if mega else 1, [cfg.max_cycles])


def _unpack_result(final, gm: GraphMemory, b: int | None = None,
                   cfg: OverlayConfig | None = None) -> SimResult:
    """The result of a solo state, or of element ``b`` of a batched one; its
    traces where ``cfg`` carries a ``TelemetrySpec``."""
    if b is not None:
        final = element(final, b)
    value = final["value"].reshape(gm.num_pes, gm.lmax).cpu().numpy()
    telemetry = None
    if cfg is not None and cfg.telemetry is not None:
        telemetry = telemetry_result.TelemetryResult(
            spec=cfg.telemetry,
            traces={k: v.cpu().numpy() for k, v in final["telem"].items()},
            cycles=int(final["cycle"]), nx=gm.nx, ny=gm.ny)
    return SimResult(
        cycles=int(final["cycle"]),
        done=bool(final["done"]),
        values=value[gm.node_pe, gm.node_slot],
        delivered=int(final["delivered"]),
        deflections=int(final["deflections"]),
        busy_cycles=int(final["busy_cycles"]),
        noc_deflections=int(final["noc_deflections"]),
        eject_deflections=int(final["eject_deflections"]),
        telemetry=telemetry,
    )


def _as_memory(gm, cfg: OverlayConfig, nx: int | None, ny: int | None,
               device=None):
    """Accept a packed GraphMemory or a raw DataflowGraph (+ grid shape).

    A raw graph is placed according to ``cfg.placement`` (identity default;
    a search runs on ``device``) with the memory layout the scheduler
    prefers — the placement subsystem's integration point into every
    engine."""
    if isinstance(gm, GraphMemory):
        return gm
    if isinstance(gm, DataflowGraph):
        if nx is None or ny is None:
            raise ValueError(
                "simulating a raw DataflowGraph needs the PE grid: "
                "pass nx= and ny=")
        from ..place.api import graph_memory_for_config

        return graph_memory_for_config(gm, nx, ny, cfg, device=device)
    raise TypeError(f"expected GraphMemory or DataflowGraph, got {type(gm)}")


def _simulate(gm: GraphMemory | DataflowGraph,
              cfg: OverlayConfig | None = None, *,
              nx: int | None = None, ny: int | None = None,
              device=None) -> SimResult:
    """Run the overlay to completion on one device (behind
    :func:`repro_torch.run`)."""
    cfg = cfg or OverlayConfig()
    gm = _as_memory(gm, cfg, nx, ny, device)
    g = device_graph(gm, device)
    final = run_state(g, cfg, init_state(g, cfg))
    return _unpack_result(final, gm, cfg=cfg)


# ---------------------------------------------------------------------------
# Batched sweep engine: one graph under many configs, stepped together.
# ---------------------------------------------------------------------------

def init_batch_state(g: DeviceGraph, base: OverlayConfig, names, policy_ids,
                     sel_lats) -> dict:
    """The state of a batch: :func:`init_state` under the
    :class:`~repro_torch.core.schedulers.BatchedScheduler` of ``names``,
    with a leading ``[B]`` axis on every leaf (links ``[B, 6, nx, ny]``, so
    element ``b``'s view is a contiguous solo-layout tensor). ``policy_id``
    and ``sel_lat`` are ``[B]``, and ``sel_wait`` starts at
    ``sel_lat - 1`` per element."""
    one = init_state(g, base, scheduler=schedulers.BatchedScheduler(names))
    B = len(policy_ids)

    def stack(tree):
        return {k: stack(v) if isinstance(v, dict)
                else v.unsqueeze(0).repeat(B, *(1,) * v.dim())
                for k, v in tree.items()}

    state = stack(one)
    dev = g["opcode"].device
    state["sched"]["policy_id"] = torch.tensor(policy_ids, dtype=torch.int32,
                                               device=dev)
    lat = torch.tensor(sel_lats, dtype=torch.int32, device=dev)
    state["sel_lat"] = lat
    state["sel_wait"] = (lat - 1).reshape(B, 1, 1).expand_as(
        state["sel_wait"]).contiguous()
    return state


@torch.inference_mode()
def run_batch_state(g: DeviceGraph, cfg: OverlayConfig, names, state: dict,
                    max_cycles) -> dict:
    """Advance a batched state until every element is done or at its own
    budget ``max_cycles[b]``. Whole chunks run while some element runs and
    every running element has a full chunk of budget left (elements that
    are done run on as fixed points, their cycle repaired); then the tail
    runs cycle by cycle and freezes each element that is done or at its
    budget. The host reads ``done`` [B] once per chunk and tail cycle.

    As in :func:`run_state`, the megakernel engine keeps one chunk queued
    while every running element's budget allows it, and runs its tail as
    chunks of one cycle, so every cycle of its batch goes through its
    kernel."""
    nx, ny, L = g["opcode"].shape
    dev = g["opcode"].device
    K = resolve_check_every(cfg, nx, ny, L, device_type=dev.type)
    mega = cfg.engine == "megakernel"
    budget = [int(m) for m in max_cycles]
    cycle_fn = None if mega else make_cycle_fn(
        g, cfg, scheduler=schedulers.BatchedScheduler(names))
    chunk = (make_engine_chunk_fn(g, cfg, K, cycle_fn=cycle_fn, names=names)
             if K > 1 or mega else None)
    step = make_engine_chunk_fn(
        g, cfg, 1, cycle_fn=cycle_fn, names=names,
        max_cycles=torch.tensor(budget, dtype=torch.int32, device=dev))
    return _drive(state, chunk, step, K, 2 if mega else 1, budget)


def _simulate_batch(gm: GraphMemory | DataflowGraph, cfgs, *,
                    nx: int | None = None, ny: int | None = None,
                    device=None) -> list[SimResult]:
    """Run one graph under many configs as one batch (behind
    :func:`repro_torch.run` with ``batch=``). Every element's result equals
    the solo run of its config. The configs must share ``eject_capacity``,
    ``eject_policy``, ``engine``, ``placement`` and ``telemetry``; a raw
    ``DataflowGraph`` also needs one memory layout (a uniform
    ``wants_criticality_order``)."""
    cfgs = list(cfgs)
    if not cfgs:
        return []
    for knob in ("eject_capacity", "eject_policy", "engine", "placement",
                 "telemetry"):
        got = {getattr(c, knob) for c in cfgs}
        if len(got) != 1:
            raise ValueError(f"run(batch=) needs a uniform {knob}, got {got}")
    if not isinstance(gm, GraphMemory):
        wants = {schedulers.get(c.scheduler).wants_criticality_order
                 for c in cfgs}
        if len(wants) != 1:
            raise ValueError(
                "run(batch=) over a raw DataflowGraph needs schedulers with a "
                "uniform wants_criticality_order; group configs by memory "
                "layout or pass a pre-built GraphMemory")
    gm = _as_memory(gm, cfgs[0], nx, ny, device)
    names = tuple(dict.fromkeys(c.scheduler for c in cfgs))
    base = dataclasses.replace(cfgs[0], scheduler=names[0],
                               select_latency=None,
                               max_cycles=max(c.max_cycles for c in cfgs))
    g = device_graph(gm, device)
    num_words = g["opcode"].shape[2] // bitvec.FLAGS_PER_WORD
    state = init_batch_state(
        g, base, names, [names.index(c.scheduler) for c in cfgs],
        [schedulers.get(c.scheduler).sel_lat(c, num_words) for c in cfgs])
    final = run_batch_state(g, base, names, state,
                            [c.max_cycles for c in cfgs])
    return [_unpack_result(final, gm, b, cfg=base) for b in range(len(cfgs))]
