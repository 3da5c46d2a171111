"""Pluggable ready-node scheduler policies for the overlay simulator.

The cycle kernel in :mod:`repro_torch.core.overlay` only talks to this
protocol:

  * ``init(g, cfg)``                      -> per-PE scheduler state dict
  * ``on_ready(st, slot, ready)``         -> mark ``slot`` ready where ``ready``
  * ``select(st, idle)``                  -> (candidate slot, have) per PE
  * ``commit(st, sel, cand)``             -> consume the candidate where ``sel``
  * ``empty(st)``                         -> 0-dim bool: no node is queued
  * ``ready_depth(st)``                   -> [nx, ny] int32 queued-ready count
    (the telemetry probe; called only when tracing is on)
  * ``sel_lat(cfg, num_words)``           -> exposed select latency (cycles)

Its per-cycle entry point is ``step(st, idle, gate, use_kernels=...) ->
(cand, have, st)``; the base class composes ``select`` + ``commit``, while
``ooo``/``scan``/``lru_flat`` do the pick and the RDY clear in one call of
:mod:`repro_torch.kernels.lod`: its fused leading-one kernel under
``OverlayConfig(engine="select")``, its plain version (the same
:mod:`repro_torch.core.bitvec` ops as ``select`` + ``commit``) under
``engine="tensor"``.

Registered policies:

  * ``ooo``      — packed RDY bit-flags + hierarchical OuterLOD/InnerLOD pick;
                   with criticality-ordered local memory the pick is the most
                   critical ready node (the paper's contribution).
  * ``inorder``  — FIFO in arrival order (FCFS), the prior-TDP baseline.
  * ``scan``     — the naive memory scan the paper rejects: a rotating
                   pointer walks the RDY vector; the exposed pick latency
                   defaults to the RDY word count.
  * ``lru_flat`` — flat LOD with rotating least-recently-granted priority
                   and a 1-cycle pick: fair, but blind to criticality.

All hooks are torch functions of [nx, ny, ...] tensors and update nothing in
place. Every [nx, ny] argument holds one entry per PE; so, unlike the
reference's hook, ``on_ready`` needs no PE coordinates. RDY words are int32 storage of the uint32 bit pattern
(:mod:`repro_torch.core.bitvec`).
"""
from __future__ import annotations

import torch

from ..kernels import lod
from . import bitvec


def row_gather(arr, idx):
    """arr: [nx, ny, L(, ...)], idx: [nx, ny] -> arr[x, y, idx[x, y]], with
    the index clamped into [0, L)."""
    idxc = idx.clamp(0, arr.shape[2] - 1).to(torch.int64)
    tail = arr.shape[3:]
    index = idxc.reshape(*idx.shape, 1, *(1,) * len(tail)).expand(
        *idx.shape, 1, *tail)
    return torch.gather(arr, 2, index).reshape(idx.shape + tail)


def _initial_ready(g):
    """Inputs with fanouts are ready at cycle 0 (they must drain tokens)."""
    is_input = (g["fanin"] == 0) & g["valid"]
    return is_input & (g["fo_count"] > 0)


def _rdy_image(need_drain):
    """[nx, ny, L] bool -> packed [nx, ny, W] RDY words (int32 storage)."""
    nx, ny, L = need_drain.shape
    W = L // bitvec.FLAGS_PER_WORD
    slots = torch.arange(L, dtype=torch.int64, device=need_drain.device)
    bit = torch.ones_like(slots) << (31 - slots % 32)
    masks = torch.where(need_drain, bit, torch.zeros_like(bit))
    # Distinct powers of two: the sum of a word's masks is their OR.
    return bitvec.narrow(masks.reshape(nx, ny, W, 32).sum(dim=-1))


def _set_rdy_bit(rdy, slot, on):
    """Set bit ``slot`` on PEs where ``on``: a gather/scatter along the word
    axis, one word per PE."""
    word, mask = bitvec.slot_word_mask(slot)
    row = torch.gather(rdy, 2, word[..., None])[..., 0]
    new = torch.where(on, row | mask, row)
    return rdy.scatter(2, word[..., None], new[..., None])


class Scheduler:
    """Base policy. Subclasses override the hooks; see the module docstring."""

    name: str = "?"
    #: whether the policy exploits criticality-ordered local memory (picks
    #: the GraphMemory layout a raw graph is packed with).
    wants_criticality_order: bool = True

    def sel_lat(self, cfg, num_words: int) -> int:
        """Exposed select latency in cycles."""
        return cfg.sel_lat

    def init(self, g, cfg) -> dict:
        raise NotImplementedError

    def on_ready(self, st: dict, slot, ready) -> dict:
        raise NotImplementedError

    def select(self, st: dict, idle):
        raise NotImplementedError

    def commit(self, st: dict, sel, cand) -> dict:
        raise NotImplementedError

    def empty(self, st: dict):
        raise NotImplementedError

    def ready_depth(self, st: dict):
        """[nx, ny] int32 count of queued-ready nodes per PE: the probe
        behind :mod:`repro_torch.telemetry`'s ready-set-depth trace. Purely
        observational: the cycle calls it only when a ``TelemetrySpec``
        asks for scheduler traces."""
        raise NotImplementedError

    def step(self, st: dict, idle, gate, *, use_kernels: bool = False):
        """Fused select + commit: the cycle kernel's per-cycle entry point.

        ``gate`` marks PEs whose pick is consumed this cycle (idle and past
        the exposed select latency); the candidate is committed where
        ``gate & have``. Policies with a fused kernel override this to do the
        pick and the RDY clear in one call (one launch when ``use_kernels``).
        """
        cand, have = self.select(st, idle)
        return cand, have, self.commit(st, gate & have, cand)


REGISTRY: dict[str, Scheduler] = {}


def register(cls):
    """Class decorator: instantiate and add to the policy REGISTRY."""
    inst = cls()
    if inst.name in REGISTRY:
        raise ValueError(f"duplicate scheduler name {inst.name!r}")
    REGISTRY[inst.name] = inst
    return cls


def get(name: str) -> Scheduler:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {sorted(REGISTRY)}"
        ) from None


@register
class OooScheduler(Scheduler):
    """Packed RDY bit-flags + hierarchical leading-one detect (paper §II-B)."""

    name = "ooo"
    wants_criticality_order = True

    def init(self, g, cfg):
        return dict(rdy=_rdy_image(_initial_ready(g)))

    def on_ready(self, st, slot, ready):
        return dict(st, rdy=_set_rdy_bit(st["rdy"], slot, ready))

    def select(self, st, idle):
        cand = bitvec.leading_one(st["rdy"])   # most critical ready slot
        return cand, cand >= 0

    def commit(self, st, sel, cand):
        return dict(st, rdy=bitvec.clear_slot(st["rdy"], cand, sel))

    def empty(self, st):
        return (st["rdy"] == 0).all()

    def ready_depth(self, st):
        return bitvec.count_set(st["rdy"])

    def step(self, st, idle, gate, *, use_kernels=False):
        nx, ny, W = st["rdy"].shape
        fn = lod.schedule_step if use_kernels else lod.schedule_step_plain
        slot, newbits = fn(st["rdy"].reshape(nx * ny, W), gate.reshape(nx * ny))
        cand = slot.reshape(nx, ny)
        return cand, cand >= 0, dict(st, rdy=newbits.reshape(nx, ny, W))


@register
class InorderScheduler(Scheduler):
    """FIFO in arrival order (FCFS) — the prior-TDP baseline. Depth is the
    deadlock-free worst case: every local slot simultaneously ready."""

    name = "inorder"
    wants_criticality_order = False

    def init(self, g, cfg):
        nx, ny, L = g["opcode"].shape
        need_drain = _initial_ready(g)
        slots = torch.arange(L, dtype=torch.int32, device=need_drain.device)
        # FIFO pre-loaded with ready inputs in ascending slot (arrival) order.
        order_key = torch.where(need_drain, slots, torch.full_like(slots, L))
        fifo_init = torch.sort(order_key, dim=-1).values
        fifo = torch.where(fifo_init < L, fifo_init, torch.full_like(fifo_init, -1))
        return dict(
            fifo=fifo,
            head=torch.zeros((nx, ny), dtype=torch.int32, device=fifo.device),
            size=need_drain.sum(dim=-1, dtype=torch.int32),
        )

    def on_ready(self, st, slot, ready):
        fifo, head, size = st["fifo"], st["head"], st["size"]
        depth = fifo.shape[-1]
        tail = ((head + size) % depth).to(torch.int64)[..., None]
        old = torch.gather(fifo, 2, tail)[..., 0]
        fifo = fifo.scatter(2, tail, torch.where(ready, slot, old)[..., None])
        return dict(fifo=fifo, head=head, size=size + ready.to(torch.int32))

    def select(self, st, idle):
        return row_gather(st["fifo"], st["head"]), st["size"] > 0

    def commit(self, st, sel, cand):
        depth = st["fifo"].shape[-1]
        head = torch.where(sel, (st["head"] + 1) % depth, st["head"])
        size = torch.where(sel, st["size"] - 1, st["size"])
        return dict(st, head=head, size=size)

    def empty(self, st):
        return (st["size"] == 0).all()

    def ready_depth(self, st):
        return st["size"]


class _RotatingRdyScheduler(Scheduler):
    """Shared machinery: RDY bit vector scanned from a rotating pointer.

    The pick is the first ready slot at/after the pointer (wrapping), i.e.
    rotating / least-recently-granted priority — deliberately blind to the
    criticality slot ordering the ``ooo`` policy exploits.
    """

    wants_criticality_order = False

    def init(self, g, cfg):
        nx, ny, _ = g["opcode"].shape
        rdy = _rdy_image(_initial_ready(g))
        return dict(rdy=rdy, ptr=torch.zeros((nx, ny), dtype=torch.int32,
                                             device=rdy.device))

    def on_ready(self, st, slot, ready):
        return dict(st, rdy=_set_rdy_bit(st["rdy"], slot, ready))

    def select(self, st, idle):
        cand = bitvec.rotating_leading_one(st["rdy"], st["ptr"])
        return cand, cand >= 0

    def commit(self, st, sel, cand):
        rdy = bitvec.clear_slot(st["rdy"], cand, sel)
        L = rdy.shape[-1] * bitvec.FLAGS_PER_WORD
        ptr = torch.where(sel, (cand.clamp(0, L - 1) + 1) % L, st["ptr"])
        return dict(rdy=rdy, ptr=ptr)

    def empty(self, st):
        return (st["rdy"] == 0).all()

    def ready_depth(self, st):
        return bitvec.count_set(st["rdy"])

    def step(self, st, idle, gate, *, use_kernels=False):
        nx, ny, W = st["rdy"].shape
        L = W * bitvec.FLAGS_PER_WORD
        fn = (lod.rotating_schedule_step if use_kernels
              else lod.rotating_schedule_step_plain)
        slot, newbits = fn(
            st["rdy"].reshape(nx * ny, W), st["ptr"].reshape(nx * ny),
            gate.reshape(nx * ny))
        cand = slot.reshape(nx, ny)
        have = cand >= 0
        ptr = torch.where(gate & have, (cand + 1) % L, st["ptr"])
        return cand, have, dict(rdy=newbits.reshape(nx, ny, W), ptr=ptr)


@register
class ScanScheduler(_RotatingRdyScheduler):
    """The naive memory scan the paper rejects: the pick walks graph memory
    word by word, so its exposed latency defaults to the RDY word count.
    Override with ``cfg.select_latency`` for a shallower exposed cost."""

    name = "scan"

    def sel_lat(self, cfg, num_words):
        if cfg.select_latency is not None:
            return cfg.select_latency
        return max(1, num_words)


@register
class LruFlatScheduler(_RotatingRdyScheduler):
    """Single-level (flat) LOD, rotating priority, 1-cycle exposed pick —
    the fair-arbiter ablation: as fast as ``ooo`` per pick but unable to
    exploit criticality ordering."""

    name = "lru_flat"


class BatchedScheduler(Scheduler):
    """Composite policy of the batched sweep engine.

    Holds every member policy's state side by side under its name, plus the
    element's ``policy_id`` (the index of its member in ``names``):
    ``{name: substate, ..., "policy_id": 0-dim int32}``. ``on_ready`` goes to
    every member, so an inactive member's state keeps advancing (an
    ``inorder`` FIFO keeps taking pushes while ``ooo`` picks); ``step``
    runs each member under ``gate & (policy_id == i)``, so only the active
    member commits, and returns the active member's pick; ``empty``
    dispatches on ``policy_id``, and so does ``ready_depth``. The cycle calls
    only ``on_ready``, ``step``, ``empty`` and (tracing) ``ready_depth``.
    Each batch element is thus cycle-exact with the solo run of its member,
    and its inactive substates equal the reference's leaf for leaf. With a
    single member the dispatch is pruned.
    """

    name = "batched"
    wants_criticality_order = True

    def __init__(self, names: tuple[str, ...] = ()):
        self.names = tuple(names)
        self.policies = [get(n) for n in self.names]

    def sel_lat(self, cfg, num_words):
        # Placeholder: init_batch_state sets sel_lat/sel_wait per element.
        return 1

    def init(self, g, cfg):
        st = {n: p.init(g, cfg) for n, p in zip(self.names, self.policies)}
        st["policy_id"] = torch.zeros((), dtype=torch.int32,
                                      device=g["opcode"].device)
        return st

    @property
    def _solo(self):
        return len(self.policies) == 1

    def _members(self):
        return enumerate(zip(self.names, self.policies))

    @staticmethod
    def _dispatch(preds, values):
        """The value of the member whose predicate holds (member 0's when
        none does, as ``jnp.select``'s default)."""
        out = values[0]
        for pred, v in zip(preds[1:], values[1:]):
            out = torch.where(pred, v, out)
        return out

    def _preds(self, st):
        return [st["policy_id"] == i for i in range(len(self.policies))]

    def on_ready(self, st, slot, ready):
        out = dict(st)
        for _, (n, p) in self._members():
            out[n] = p.on_ready(st[n], slot, ready)
        return out

    def empty(self, st):
        if self._solo:
            return self.policies[0].empty(st[self.names[0]])
        return self._dispatch(self._preds(st), [
            p.empty(st[n]) for _, (n, p) in self._members()])

    def ready_depth(self, st):
        """The active member's depth, as ``empty`` dispatches."""
        if self._solo:
            return self.policies[0].ready_depth(st[self.names[0]])
        return self._dispatch(self._preds(st), [
            p.ready_depth(st[n]) for _, (n, p) in self._members()])

    def step(self, st, idle, gate, *, use_kernels=False):
        out = dict(st)
        if self._solo:
            n = self.names[0]
            cand, have, out[n] = self.policies[0].step(
                st[n], idle, gate, use_kernels=use_kernels)
            return cand, have, out
        # Each member commits its own candidate under its dispatch predicate;
        # where the predicate holds, the member's candidate IS the dispatched
        # candidate, as the reference's select-then-masked-commit gives.
        preds = self._preds(st)
        cands, haves = [], []
        for i, (n, p) in self._members():
            c, h, out[n] = p.step(st[n], idle, gate & preds[i],
                                  use_kernels=use_kernels)
            cands.append(c)
            haves.append(h)
        return self._dispatch(preds, cands), self._dispatch(preds, haves), out
