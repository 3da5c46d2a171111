"""Sharding rules and placements: the counterpart of the reference package's
``distributed/sharding.py``, over a :class:`torch.distributed.device_mesh.DeviceMesh`
with dims ``("data", "model")`` (``("pod", "data", "model")`` across pods).

The rules are the reference's (its DESIGN.md section 6):

  * column-parallel weights  [d_in, d_out]   -> (fsdp, "model")
  * row-parallel weights     [d_out, d_in']  -> ("model", fsdp)
  * embeddings [V, d] vocab-parallel          -> ("model", fsdp)
  * MoE experts [E, d, f] / [E, f, d]         -> E over "model", d over fsdp
  * small tensors (norms, biases, routers, conv, SSM scalars) replicate
  * optimizer state mirrors params

``fsdp`` is the "data" axis when ``cfg.fsdp``, else None (replicated). A
leading "pod" axis folds into the data-parallel group (:func:`data_axes`).

A spec (:class:`P`) is the reference's ``PartitionSpec``: one entry a tensor
dim, each None, an axis name, or a tuple of names (the dim sharded over
their product, the first name major). The rule keys on the reference's
parameter paths (``segments/0/attn/wq/w``); the port's parameters are per
layer (``blocks.0.attn.wq.w``), so each port leaf takes the spec of the
reference path it came from (:func:`repro_torch.convert._leaf_names`) for
its own dims: the reference's leading None for the layer stack falls away.

:func:`to_shardings` turns specs into DTensor placements: one per mesh dim,
``Shard(d)`` where the spec shards tensor dim ``d`` over that mesh dim,
else ``Replicate()``. A dim over folded axes is sharded on each of their
mesh dims; DTensor splits it over the mesh dims in order, major first, which
is JAX's order for a folded entry. :func:`local_block` and
:func:`from_local` make a rank's DTensor from the whole tensor and
:func:`full_tensors` gathers it back.

Transport (:func:`route`): under gloo a CUDA tensor is staged through
pinned host memory, as gloo's collectives take host memory; under NCCL,
and on the CPU, tensors go directly; under the fake backend (the
dry-run's, ``torch.testing._internal.distributed.fake_pg``) nothing moves
and nothing is staged. No DTensor collective is used. :data:`stats`
counts the collectives and their bytes since :func:`reset_stats`, and
:data:`records` keeps one ``(kind, result bytes, group size)`` a
collective (:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..optim.adamw import named_tensors

class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"), None)``,
    ``P()`` (replicated; missing trailing entries are None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Specs (the reference's rules; they read only the mesh's shape and names).
# ---------------------------------------------------------------------------

def _axis_names(mesh) -> tuple:
    """The mesh's axis names: a DeviceMesh's dim names, or a stand-in's
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None) or getattr(
        mesh, "axis_names", None)
    if not names:
        raise ValueError(f"a mesh with named dims is needed, got {mesh!r}")
    return tuple(names)


def _shape(mesh) -> dict:
    """Axis name -> size: a DeviceMesh's, or a stand-in's ``shape`` dict
    (as the reference's ``Mesh.shape``)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(_axis_names(mesh), tuple(shape)))


def data_axes(mesh):
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def _axes(entry) -> tuple:
    """A spec entry's axis names, major first."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _axis_size(mesh, axis) -> int:
    sizes = _shape(mesh)
    n = 1
    for a in _axes(axis):
        n *= sizes[a]
    return n


def fix_divisibility(spec, shape, mesh) -> P:
    """Drop sharding on dims the mesh axis size doesn't divide: the
    reference's rule (replication is the safe fallback)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    fixed = []
    for d, ax in zip(shape, dims):
        n = _axis_size(mesh, ax)
        fixed.append(ax if (n > 1 and d % n == 0) or n == 1 else None)
    return P(*fixed)


def _rule(path: str, ndim: int, cfg):
    """Trailing-dims spec for a reference parameter path."""
    f = "data" if cfg.fsdp else None
    # --- MoE expert tensors (3D, expert-major) ---
    if path.endswith("ffn/w_gate") or path.endswith("ffn/w_up"):
        return ("model", f, None)
    if path.endswith("ffn/w_down"):
        return ("model", None, f)
    if "router" in path:
        return (None, None)
    # --- embeddings / head ---
    if path.endswith("embed"):
        return ("model", f)
    if path.endswith("lm_head"):
        return (f, "model")
    # --- MLA ---
    if "w_dkv" in path:
        return (f, None)
    if "w_uk" in path or "w_uv" in path:
        return (None, "model")
    # --- column-parallel ---
    for k in ("wq/w", "wk/w", "wv/w", "w_gate/w", "w_up/w", "in_proj/w"):
        if path.endswith(k):
            return (f, "model")
    # --- row-parallel ---
    for k in ("wo/w", "w_down/w", "out_proj/w"):
        if path.endswith(k):
            return ("model", f)
    # --- biases on column-parallel outputs ---
    for k in ("wq/b", "wk/b", "wv/b", "w_up/b"):
        if path.endswith(k):
            return ("model",)
    # everything else (norms, conv, A_log, D, dt_bias, wo/b, w_down/b): replicate
    return tuple(None for _ in range(ndim))


def _leaf_spec(path: str, shape, cfg, mesh) -> P:
    """The spec of a leaf of ``shape`` whose reference path is ``path``:
    the rule's trailing dims (leading None where the leaf has more dims,
    cut where it has fewer), then the divisibility guard."""
    rule = tuple(_rule(path, len(shape), cfg))
    if len(rule) < len(shape):
        rule = (None,) * (len(shape) - len(rule)) + rule
    elif len(rule) > len(shape):
        rule = rule[-len(shape):] if shape else ()
    return fix_divisibility(P(*rule), shape, mesh)


def _reference_paths(cfg) -> dict:
    """Port parameter name -> the reference path (``"segments/0/ffn/w_up"``)
    of the leaf it is (a layer of)."""
    from ..convert import _leaf_names

    return {name: "/".join(str(p) for p in path)
            for path, names in _leaf_names(cfg) for name in names}


def param_specs(cfg, params, mesh) -> dict:
    """``{port name: P}`` for an LM's parameters (an :class:`LM`, or tensors
    by the port's names; only the shapes are read)."""
    paths = _reference_paths(cfg)
    return {n: _leaf_spec(paths[n], tuple(t.shape), cfg, mesh)
            for n, t in named_tensors(params).items()}


def state_specs(cfg, state, mesh) -> dict:
    """Train state ``{params, opt{m, v, master, count}, step}`` -> specs:
    the optimizer's moments and master weights mirror the parameters'
    specs; ``count`` and ``step`` replicate."""
    out = {"params": param_specs(cfg, state["params"], mesh), "step": P()}
    out["opt"] = {k: P() if k == "count" else param_specs(cfg, v, mesh)
                  for k, v in state["opt"].items()}
    return out


def _map_with_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over nested dicts, lists and tuples; the path
    joins keys and indices with ``/`` as the reference's ``_path_str``."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def batch_specs(cfg, batch, mesh):
    """Each batch leaf's rows over the data axes (replicated where they do
    not divide); a scalar replicates."""
    dp = data_axes(mesh)

    def spec(path, leaf):
        if leaf.ndim == 0:
            return P()
        return fix_divisibility(P(dp, *([None] * (leaf.ndim - 1))),
                                tuple(leaf.shape), mesh)

    return _map_with_path(spec, batch)


def cache_specs(cfg, cache, mesh, *, seq_shard: bool):
    """KV/SSM/latent cache specs (:func:`repro_torch.models.lm.init_cache`'s
    tree, the reference's layout). seq_shard=False (batched decode): batch
    over data, kv-heads over model; seq_shard=True (batch 1): the sequence
    over data. Leaves: attn k/v [L, b, S, hkv, hd]; MLA ckv [L, b, S, kvr],
    kr [L, b, S, dr]; SSM state [L, b, h, p, n], conv [L, b, k-1, c]."""
    dp = data_axes(mesh)

    def spec(ps, leaf):
        nd = leaf.ndim
        shape = tuple(leaf.shape)
        if "state" in ps:
            s = (P(None, None, "model", None, None) if seq_shard
                 else P(None, dp, "model", None, None))
        elif "conv" in ps:
            s = (P(None, None, None, "model") if seq_shard
                 else P(None, dp, None, "model"))
        elif ps.endswith("k") or ps.endswith("v"):
            s = (P(None, None, dp, "model", None) if seq_shard
                 else P(None, dp, None, "model", None))
            # kv-head dim often < model size (GQA/MQA): fall back to head_dim
            m = _axis_size(mesh, "model")
            if shape[3] % m != 0 and shape[4] % m == 0:
                s = P(s[0], s[1], s[2], None, "model")
        elif "ckv" in ps or "kr" in ps:
            s = (P(None, None, dp, None) if seq_shard
                 else P(None, dp, None, None))
        else:
            s = P(*([None] * nd))
        return fix_divisibility(s, shape, mesh)

    return _map_with_path(spec, cache)


def shard_shape(shape, spec, mesh) -> tuple:
    """A rank's block shape of a ``shape`` tensor under ``spec`` (the
    divisibility guard has run: every sharded dim divides)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(d // _axis_size(mesh, ax) for d, ax in zip(shape, dims))


# ---------------------------------------------------------------------------
# Placements.
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """A spec on a mesh and its DTensor placements, one per mesh dim (the
    reference's ``NamedSharding``)."""
    mesh: object
    spec: P
    placements: tuple


def placements(spec, mesh) -> tuple:
    """``Shard(d)`` on each mesh dim that ``spec`` shards tensor dim ``d``
    over, ``Replicate()`` on the others. A folded entry lists its axes in
    mesh order (major first), the order DTensor splits a dim in."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the folded axes {entry} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if out[i].is_shard():
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            out[i] = Shard(d)
    return tuple(out)


def to_shardings(mesh, specs):
    """The tree ``specs`` with each spec made a :class:`Sharding` on
    ``mesh``."""
    if isinstance(specs, P):
        return Sharding(mesh, specs, placements(specs, mesh))
    if isinstance(specs, Mapping):
        return {k: to_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(to_shardings(mesh, v) for v in specs)
    raise TypeError(f"not a spec tree: {specs!r}")


def _block(shape, sharding: Sharding):
    """This rank's block of a ``shape`` tensor: per dim (start, length)."""
    mesh, plc = sharding.mesh, sharding.placements
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    out = []
    for d, n in enumerate(shape):
        index, parts = 0, 1
        for i, p in enumerate(plc):
            if p.is_shard() and p.dim == d:
                index = index * mesh.size(i) + coord[i]
                parts *= mesh.size(i)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into "
                             f"{parts} blocks")
        out.append((index * (n // parts), n // parts))
    return out


def local_block(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a view)."""
    for d, (start, length) in enumerate(_block(t.shape, sharding)):
        t = t.narrow(d, start, length)
    return t


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, sharding: Sharding, shape):
    """A DTensor of global ``shape`` whose block on this rank is ``local``
    (no collective). The mesh's device type must be the tensor's."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    if mesh.device_type != local.device.type:
        raise ValueError(f"the mesh's device type {mesh.device_type!r} is "
                         f"not the tensor's ({local.device}): make the mesh "
                         f"with device_type={local.device.type!r}")
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

#: Collectives launched since :func:`reset_stats` (``all_gather``: one
#: buffer gathered along one mesh dim; ``all_reduce``: one buffer reduced
#: over one group), ``bytes``, the payload this rank handed them, and the
#: host's seconds in each kind (``all_gather_s``, ``all_reduce_s``; the
#: staging copies included).
stats: dict = {"all_gather": 0, "all_reduce": 0, "bytes": 0,
               "all_gather_s": 0.0, "all_reduce_s": 0.0}

#: One record a collective since :func:`reset_stats`: ``(kind, result
#: bytes, group size)``, the kind named as XLA names it (``"all-gather"``,
#: ``"all-reduce"``). An all-gather's result is S payloads (``stats``
#: counts the payload alone); an all-reduce's is its buffer.
#: :func:`repro_torch.distributed.collectives.collective_bytes` reads them.
records: list = []

#: Pinned host buffers of the staged collectives, by (dtype, numel), kept
#: for the next step's collectives of the same sizes.
_pinned: dict = {}


def reset_stats() -> None:
    stats.update(all_gather=0, all_reduce=0, bytes=0, all_gather_s=0.0,
                 all_reduce_s=0.0)
    records.clear()


def _staged(group, device: torch.device) -> bool:
    """Whether a collective on ``group`` stages a ``device`` tensor through
    host memory (gloo takes host memory)."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of device tensor ``t`` (complete on return), in a
    buffer kept for the next collective of its size."""
    key = (t.dtype, t.numel())
    if key not in _pinned:
        _pinned[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
    out = _pinned[key].view(t.shape)
    out.copy_(t)
    return out


def route(mesh, device) -> str:
    """How collectives on ``mesh`` travel for tensors on ``device``."""
    device = torch.device(device)
    if mesh.size() == 1:
        return "none (one rank: no collective)"
    backend = dist.get_backend(mesh.get_group(0))
    if device.type == "cuda":
        how = "pinned host buffers" if backend == "gloo" else "device tensors"
    else:
        how = "host tensors"
    return f"{backend}, {how}"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (staged under gloo on the
    card); returns ``t``."""
    start = time.perf_counter()
    if _staged(group, t.device):
        buf = _host(t)
        dist.all_reduce(buf, op=op, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, op=op, group=group)
    stats["all_reduce"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    records.append(("all-reduce", t.numel() * t.element_size(),
                    dist.get_world_size(group)))
    stats["all_reduce_s"] += time.perf_counter() - start
    return t


def _line_ranks(mesh, i: int) -> list:
    """Global ranks along mesh dim ``i`` through this rank, by coordinate
    (read from the mesh's rank table, a real tensor, also where a fake
    tensor mode is active)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    coord = mesh.get_coordinate()
    index = tuple(slice(None) if j == i else c for j, c in enumerate(coord))
    with unset_fake_temporarily():
        return mesh.mesh[index].tolist()


def _gather_parts(t: torch.Tensor, mesh, i: int) -> list:
    """The tensors ``t`` of the ranks along mesh dim ``i`` (one collective),
    by coordinate, on ``t``'s device."""
    start = time.perf_counter()
    group = mesh.get_group(i)
    staged = _staged(group, t.device)
    src = _host(t) if staged else t.contiguous()
    parts = [torch.empty(src.shape, dtype=src.dtype, device=src.device)
             for _ in range(mesh.size(i))]
    dist.all_gather(parts, src, group=group)
    parts = [parts[dist.get_group_rank(group, r)]
             for r in _line_ranks(mesh, i)]
    if staged:
        parts = [p.to(t.device) for p in parts]
    stats["all_gather"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    records.append(("all-gather", len(parts) * t.numel() * t.element_size(),
                    len(parts)))
    stats["all_gather_s"] += time.perf_counter() - start
    return parts


def full_tensors(ts, *, keep: int | None = None) -> list:
    """The whole tensors of the DTensors ``ts`` (one mesh; plain tensors
    pass as they are), on their device. Every rank of the mesh calls it,
    in the same order. Along each sharded mesh dim, minor first, the blocks
    of every tensor sharded there go in one collective a dtype (their
    blocks flattened into one buffer). With ``keep``, tensor dim ``keep``
    stays as this rank's block (the mesh dims that shard it are not
    gathered): the whole of every other dim of the rank's rows."""
    outs = [t.to_local() if is_sharded(t) else t for t in ts]
    dts = [t for t in ts if is_sharded(t)]
    if not dts:
        return outs
    mesh = dts[0].device_mesh
    if any(t.device_mesh != mesh for t in dts):
        raise ValueError("the tensors lie on different meshes")
    for i in reversed(range(mesh.ndim)):
        if mesh.size(i) == 1:
            continue
        picked = [k for k, t in enumerate(ts)
                  if is_sharded(t) and t.placements[i].is_shard()
                  and t.placements[i].dim != keep]
        for dtype in dict.fromkeys(outs[k].dtype for k in picked):
            ks = [k for k in picked if outs[k].dtype == dtype]
            flat = torch.cat([outs[k].reshape(-1) for k in ks])
            parts = _gather_parts(flat, mesh, i)
            at = 0
            for k in ks:
                n, shape = outs[k].numel(), outs[k].shape
                outs[k] = torch.cat([p[at:at + n].view(shape) for p in parts],
                                    dim=ts[k].placements[i].dim)
                at += n
    return outs


def full_tensor(t) -> torch.Tensor:
    """The whole tensor of a DTensor (:func:`full_tensors`); a plain tensor
    is returned as it is."""
    return full_tensors([t])[0]


def data_groups(mesh) -> list:
    """The process groups of the mesh's data axes of more than one rank."""
    names = _axis_names(mesh)
    return [mesh.get_group(names.index(a)) for a in data_axes(mesh)
            if mesh.size(names.index(a)) > 1]


def data_index(mesh) -> tuple:
    """(this rank's index among the data ranks, their count): the folded
    data axes' coordinates, major first."""
    names, coord = _axis_names(mesh), mesh.get_coordinate()
    index, count = 0, 1
    for a in data_axes(mesh):
        i = names.index(a)
        index, count = index * mesh.size(i) + coord[i], count * mesh.size(i)
    return index, count


def reduce_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the data ranks, in place; returns ``t``."""
    for group in data_groups(mesh):
        all_reduce(t, group)
    return t
