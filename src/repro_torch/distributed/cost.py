"""Static cost of one eager step: the counterpart of the reference package's
``distributed/hlo_cost.py``.

The reference walks XLA's optimized HLO of the per-device SPMD program. The
port has no HLO; what stands in for it is one rank's eager step, run on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes
and devices, no storage) over a fake process group of the production
mesh's size (``docs/dryrun_torch.md``). :class:`Analysis` is a
``TorchDispatchMode`` that sees every aten op of the step and counts:

  * ``flops``: by ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention), exactly as ``FlopCounterMode`` counts them
    (an op without a formula is decomposed first, as there); elementwise
    ops and reductions count nothing. A hand-written kernel that runs on
    fake tensors launches nothing and adds its closed-form work by
    :func:`charge`;
  * ``bytes``: each aten op's tensor operands and results, nothing fused
    (the reference's HBM model for a top-level op); views, metadata and
    ``empty`` (an allocation, no write) are free, as the reference's
    ``_NO_TRAFFIC`` ops;
  * ``collectives``: the records :mod:`repro_torch.distributed.sharding`
    left during the step, by :func:`repro_torch.distributed.collectives.collective_bytes`;
  * the peak of live storage: every storage an op makes, from its first op
    until its last tensor dies, plus the storages of the tensors passed to
    :meth:`Analysis.track` (the step's arguments);
  * a profile: flops and bytes by the innermost ``nn.Module`` running
    (``torch.utils.module_tracker``), the counterpart of ``Module.profile``
    by ``op_name``.

An eager step runs every layer, so nothing is counted once for many trips:
``unknown_trips`` is always ``[]``. Numbers are per rank.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.module_tracker import ModuleTracker

from . import collectives, sharding

_aten = torch.ops.aten

#: Ops that ``FlopCounterMode`` hands back untouched (size and layout
#: queries).
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default,
}

#: Ops that move no bytes: allocations and aliases (views are found by
#: ``OpOverload.is_view``).
_NO_TRAFFIC = {
    _aten.empty.memory_format,
    _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.detach.default, _aten.lift_fresh.default, _aten.alias.default,
}

#: The analyses running, innermost last (:func:`charge` adds to it).
_active: list = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree) -> list:
    """The tensors of ``tree`` (dicts, lists, tuples, ``nn.Module``
    parameters; a DTensor as its local block)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    leaves, _ = tree_flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            out += local_tensors(x)
        elif isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def charge(name: str, flops: float, nbytes: float) -> None:
    """Add a launch-free kernel call's closed-form work to the innermost
    running :class:`Analysis` (none running: nothing)."""
    if _active:
        _active[-1].charge(name, float(flops), float(nbytes))


class Analysis:
    """Counts the aten ops run under it (see the module's docstring).
    ``with Analysis() as a: step(...)``, then :meth:`result`,
    :attr:`peak_bytes` and :meth:`profile`."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak_bytes = 0
        self._storages = weakref.WeakKeyDictionary()
        self._by_module: dict = defaultdict(lambda: {"bytes": 0.0,
                                                     "flops": 0.0})
        self._tracker = ModuleTracker()
        self._mode = _Counting(self)
        self._records_at = 0
        self._records: list = []

    def __enter__(self):
        self._records_at = len(sharding.records)
        self._tracker.__enter__()
        _active.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        _active.remove(self)
        self._tracker.__exit__(*exc)
        self._records = list(sharding.records[self._records_at:])
        return False

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (arguments)."""
        for t in local_tensors(tree):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":                 # holds no memory
            return
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, where: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        entry = self._by_module[where]
        entry["flops"] += flops
        entry["bytes"] += nbytes

    def _where(self) -> str:
        parents = self._tracker.parents
        return max(parents, key=len) if parents else "Global"

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        self._add(f"{self._where()}/{name}", flops, nbytes)

    # -- readings --------------------------------------------------------
    def result(self) -> dict:
        """The reference's ``hlo_cost.analyze`` keys: ``flops``, ``bytes``,
        ``collectives`` ({kind: {bytes, traffic, count}}),
        ``collective_traffic``, ``collective_count``, ``unknown_trips``."""
        coll = collectives.collective_bytes(self._records)
        kinds = {k: {"bytes": float(v["bytes"]),
                     "traffic": v["traffic_bytes"], "count": v["count"]}
                 for k, v in coll.items() if isinstance(v, dict)}
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": kinds,
                "collective_traffic": coll["total_traffic"],
                "collective_count": coll["total_count"],
                "unknown_trips": []}

    def records(self) -> list:
        """The collective records of the step."""
        return list(self._records)

    def profile(self, top: int = 25) -> dict:
        """The ``top`` module paths by bytes: {path: {bytes, flops}}; a
        charged kernel's work under ``<path>/<kernel name>``."""
        return dict(sorted(self._by_module.items(),
                           key=lambda kv: -kv[1]["bytes"])[:top])


class _Counting(TorchDispatchMode):
    """The dispatch mode of an :class:`Analysis`."""

    def __init__(self, analysis: Analysis):
        super().__init__()
        self.a = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if func is torch.ops.prim.device.default:
            return func(*args, **kwargs)
        if func not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        flops = 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        nbytes = 0
        if not (func.is_view or func in _NO_TRAFFIC):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.a._hold(t)
        if flops or nbytes:
            self.a._add(self.a._where(), flops, nbytes)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` under an :class:`Analysis`; returns its
    :meth:`~Analysis.result`."""
    with Analysis() as a:
        fn(*args, **kwargs)
    return a.result()
