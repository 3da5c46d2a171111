"""The overlay's K-cycle chunk in one launch (the "megakernel"): the CUDA
kernel and its plain torch version, solo and batched.

:func:`make_mega_chunk_fn` replaces the Pallas TPU kernel of the reference
package's ``kernels/megakernel.py`` (``make_mega_chunk_fn``) in both its
forms: it builds ``chunk(state) -> state`` running ``check_every`` cycles of
:func:`repro_torch.core.overlay.make_cycle_fn` back to back, with the
reference's chunk repair of ``cycle`` and ``done``. With ``names`` (the
member policies of a sweep) it is the batched form: the state has a leading
config axis (:func:`repro_torch.core.overlay.init_batch_state`), the done
trace is ``[K, B]`` and the repair runs per element; the kernel runs one CTA
per config. The chunk

  * on a state on the CPU runs the plain version, :func:`mega_chunk_plain`
    (the ``"tensor"`` engine's cycle, chunked by
    :func:`repro_torch.core.overlay.make_chunk_fn`) or
    :func:`mega_batch_chunk_plain` (that chunk on each element in turn);
  * on a state on a CUDA device launches the kernel of
    ``csrc/megakernel.cu`` once on the current stream, or raises. There is
    no fallback. The kernel updates every state tensor in place and the
    chunk returns the same dict.

Every graph and state leaf is checked (one device, contiguous, the dtype
and shape that ``device_graph``/``init_state``/``init_batch_state`` give
it) before the dispatch, so a malformed state raises ``ValueError`` on
either device. A state whose tensors are the last call's (the kernel
updates them in place) is not checked again.

The kernel has two bodies, and :func:`plan` alone picks one from the
shapes: ``"shared"`` keeps the Hoplite links, the active member's RDY rows
and their summaries in shared memory for the chunk and each PE's registers
in a thread's registers; ``"global"`` keeps them in device memory, a thread
looping over PEs, for any other grid (links and rows above a CTA's 227 KB,
or rows above 32,768 slots, whose pick takes a third level).

:data:`launches` counts kernel launches (``"mega_chunk"`` solo,
``"mega_chunk_batched"`` batched), each body's (``"mega_chunk_shared"``,
``"mega_chunk_global"``) and the traced variant's (``"mega_chunk_traced"``,
solo and batched), so a run can show that its main path went through the
kernel, and through which body and variant.

Telemetry. Where ``cfg.telemetry`` is a ``TelemetrySpec``, the state's
``telem`` leaves ride in the kernel's arguments and the chunk launches the
traced variant of the kernel (the same cycle with each PE's trace
increments counted by the thread that owns the PE, ``TRACED`` in
``csrc/megakernel.cu``); its trace leaves equal the plain chunk's bit for
bit, ``stall_no_ready`` included, repaired for the cycles run past
completion. ``telemetry=None`` launches the untraced variant, as before.
"""
from __future__ import annotations

import ctypes
import dataclasses
import operator
from typing import NamedTuple

import torch

from ..core import bitvec, noc, overlay, schedulers
from ..telemetry.spec import BUCKETED_LEAVES, TelemetrySpec
from . import _build

SOURCE = "megakernel.cu"

#: Kernel launches since the last :func:`reset_launches`: by form, and by
#: body.
launches: dict[str, int] = {"mega_chunk": 0, "mega_chunk_batched": 0,
                            "mega_chunk_shared": 0, "mega_chunk_global": 0,
                            "mega_chunk_traced": 0}

#: The kernel's pick of each policy (``csrc/megakernel.cu``'s ``Policy``)
#: and its eject arbitration variants (``Eject``).
POLICIES = {"ooo": 0, "inorder": 1, "scan": 2, "lru_flat": 2}
_EJECT_CAP1 = {"n_first": 0, "priority": 1}
_EJECT_CAP2 = 2
#: Member policies one state may hold (``kMaxMembers``).
MAX_MEMBERS = 4
_BODIES = {"shared": 0, "global": 1}

#: Threads a CTA with one PE a thread (``kMaxThreadsPpt1``; 128 registers
#: a thread) and otherwise (``kMaxThreads``; 112).
MAX_THREADS_PPT1 = 512
MAX_THREADS = 576
#: RDY summary words a PE of the ``shared`` body, whose top word has one bit
#: for each: a row of at most 32 x 32 words (32,768 slots). The ``global``
#: body has a level between them: 32 times as many.
MAX_SUMMARY_WORDS = 32
#: int32s of a PE's registers in the ``global`` body's scratch (``kPeInts``).
PE_INTS = 32
#: Shared memory a CTA may use on the H100 (227 KB), less the kernel's own
#: per-warp partial sums.
SHARED_BYTES = 232_448 - (MAX_THREADS // 32) * 4 * 4
#: int32s of a PE's links: two cycle parities x (E, S) x a packet padded to
#: 8 ints (``kLinkInts``).
LINK_INTS = 2 * 2 * 8


class Plan(NamedTuple):
    """How the kernel runs a chunk: ``body`` (``"shared"`` or
    ``"global"``), PEs a thread (0: a loop at the CTA's stride, the
    ``global`` body), threads a CTA, the PE stride ``pp`` of the link, RDY
    and summary rows (P rounded up to 32), summary words a PE and the
    dynamic shared memory in bytes (0 for ``"global"``)."""
    body: str
    ppt: int
    threads: int
    pp: int
    summary_words: int
    smem_bytes: int


def plan(nx: int, ny: int, L: int, members, body: str | None = None) -> Plan:
    """The body for a grid of ``nx`` x ``ny`` PEs of ``L`` slots under the
    member policies ``members``, from the shapes alone: ``"shared"`` where
    the links, and for RDY policies the RDY rows and their summaries, fit in
    :data:`SHARED_BYTES` and a row has at most :data:`MAX_SUMMARY_WORDS`
    summary words, else ``"global"``. ``body`` forces one (a check runs
    both on one state); a ``"shared"`` body that does not fit raises. The
    kernel's offsets within an element are 32-bit: grids of ``2 * P * L``
    cells from 2**31 on (32 GB of graph tables an element), sides from
    2**15 on, and rows above 2**20 slots raise ``ValueError``."""
    P, W = nx * ny, L // bitvec.FLAGS_PER_WORD
    S = -(-W // 32)
    if 2 * P * L >= 2**31 or max(nx, ny) >= 2**15:
        raise ValueError(f"the megakernel's offsets are 32-bit: a grid of "
                         f"fewer than 2**30 cells and sides below 2**15, got "
                         f"{nx}x{ny} PEs of {L} slots")
    if S > 32 * MAX_SUMMARY_WORDS:
        raise ValueError(f"the megakernel's pick covers at most "
                         f"{32 * MAX_SUMMARY_WORDS * 32 * 32} slots a PE, "
                         f"got {L}")
    pp = -(-P // 32) * 32
    rdy = any(POLICIES[m] != POLICIES["inorder"] for m in members)
    shared = 4 * (pp * LINK_INTS + (pp * S + W * (pp + 1) if rdy else 0))
    fits = shared <= SHARED_BYTES and S <= MAX_SUMMARY_WORDS
    if body is None:
        body = "shared" if fits else "global"
    if body not in _BODIES:
        raise ValueError(f"body must be one of {sorted(_BODIES)}, got {body!r}")
    if body == "shared" and not fits:
        raise ValueError(f"the shared body needs {shared} bytes of shared "
                         f"memory (a CTA has {SHARED_BYTES}) and "
                         f"{S} summary words a PE (at most "
                         f"{MAX_SUMMARY_WORDS})")
    if body == "global":
        return Plan(body, 0, min(pp, MAX_THREADS), pp, S, 0)
    ppt = 1 if P <= MAX_THREADS_PPT1 else 4
    return Plan(body, ppt, -(-P // (32 * ppt)) * 32, pp, S, shared)


def graph_tables(g: overlay.DeviceGraph):
    """The kernel's read-only graph tables, built from the graph leaves:
    ``slot_info`` ``[nx, ny, L, 2, 4]`` int32, for each slot
    ``{fo_base, fo_base + fo_count, opcode, fo_count}`` and the edge record
    at ``clamp(fo_base, 0, emax - 1)`` (what a pick reads, by address
    alone); ``edges`` ``[nx, ny, emax, 4]`` int32, each edge record as the
    routing fields of its packet, ``{dst_pe // ny, dst_pe % ny, dst_slot,
    dst_opidx}``."""
    ny = g["opcode"].shape[1]
    dst = g["e_dst_pe"]
    edges = torch.stack((dst // ny, dst % ny, g["e_dst_slot"],
                         g["e_dst_opidx"]), dim=-1).contiguous()
    emax = edges.shape[2]
    base, count = g["fo_base"], g["fo_count"]

    def record(at):
        idx = at.clamp(0, emax - 1).to(torch.int64)
        return torch.gather(edges, 2, idx[..., None].expand(*idx.shape, 4))

    info = torch.stack((base, base + count, g["opcode"], count), dim=-1)
    slot_info = torch.stack((info, record(base)), dim=3)
    return slot_info.contiguous(), edges


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def eject_variant(cfg: overlay.OverlayConfig) -> int:
    """The kernel's eject variant: the policy at capacity 1; at capacity 2
    both ports eject and the policy does not matter."""
    return _EJECT_CAP2 if cfg.eject_capacity >= 2 else _EJECT_CAP1[
        cfg.eject_policy]


def mega_chunk_plain(g: overlay.DeviceGraph, cfg: overlay.OverlayConfig,
                     check_every: int, *, with_trace: bool = False):
    """The plain version: ``check_every`` cycles of the ``"tensor"``
    engine's cycle (the pick as plain tensor ops), chunk-repaired. Returns
    ``chunk(state) -> state`` (``-> (state, done_trace [K])`` with
    ``with_trace``)."""
    cycle = overlay.make_cycle_fn(g, dataclasses.replace(cfg, engine="tensor"))
    return overlay.make_chunk_fn(cycle, check_every, with_trace=with_trace)


def mega_batch_chunk_plain(g: overlay.DeviceGraph, cfg: overlay.OverlayConfig,
                           check_every: int, names, *,
                           with_trace: bool = False, max_cycles=None):
    """The plain batched version: each element's views through the
    ``"tensor"`` engine's chunk under the
    :class:`~repro_torch.core.schedulers.BatchedScheduler` of ``names``
    (:func:`repro_torch.core.overlay.make_batch_chunk_fn`; ``max_cycles``
    freezes halted elements). ``with_trace`` also returns the ``[K, B]``
    done trace."""
    cycle = overlay.make_cycle_fn(
        g, dataclasses.replace(cfg, engine="tensor"),
        scheduler=schedulers.BatchedScheduler(names))
    return overlay.make_batch_chunk_fn(cycle, check_every,
                                       with_trace=with_trace,
                                       max_cycles=max_cycles)


# ---------------------------------------------------------------------------
# Leaf checks.
# ---------------------------------------------------------------------------

def _graph_spec(g):
    nx, ny, L = g["opcode"].shape
    emax = g["e_dst_pe"].shape[-1]
    i32, plane, edges = torch.int32, (nx, ny, L), (nx, ny, emax)
    return dict(
        opcode=(plane, i32), fanin=(plane, i32),
        init_value=(plane, torch.float32), fo_base=(plane, i32),
        fo_count=(plane, i32), valid=(plane, torch.bool),
        e_dst_pe=(edges, i32), e_dst_slot=(edges, i32),
        e_dst_opidx=(edges, i32))


def _state_spec(g, cfg, names=None, batch=None):
    """Solo (``names=None``): the state of ``cfg.scheduler``. Batched: every
    leaf with a leading ``[batch]`` axis, the states of the member policies
    ``names`` side by side under ``sched``. With ``cfg.telemetry``, the
    trace leaves of that spec under ``telem``, and no others."""
    nx, ny, L = g["opcode"].shape
    lead = () if names is None else (batch,)
    i32, plane, pe = torch.int32, (*lead, nx, ny, L), (*lead, nx, ny)
    rdy = ((*lead, nx, ny, L // bitvec.FLAGS_PER_WORD), i32)

    def member(name):
        return {"ooo": dict(rdy=rdy),
                "inorder": dict(fifo=(plane, i32), head=(pe, i32),
                                size=(pe, i32))}.get(
            name, dict(rdy=rdy, ptr=(pe, i32)))

    if names is None:
        sched = member(cfg.scheduler)
    else:
        sched = {n: member(n) for n in names}
        sched["policy_id"] = (lead, i32)
    links = ((*lead, len(noc.PKT_FIELDS), nx, ny), i32)
    spec = dict(
        pending=(plane, i32), operands=((*plane, 2), torch.float32),
        computed=(plane, torch.bool), value=(plane, torch.float32),
        remaining=(lead, i32), sched=sched,
        active=(pe, i32), cursor=(pe, i32), cursor_end=(pe, i32),
        sel_lat=(lead, i32), sel_wait=(pe, i32), link_e=links, link_s=links,
        cycle=(lead, i32), done=(lead, torch.bool),
        **{k: (lead, i32) for k in overlay.STAT_COUNTERS})
    tel = cfg.telemetry
    if tel is not None:
        bucketed = ((*lead, tel.buckets, nx, ny), i32)
        spec["telem"] = {n: bucketed if n in _BUCKETED else (pe, i32)
                         for n in tel.leaf_names()}
    return spec


def _check_tree(tree, spec, device, path):
    """Raise ``ValueError`` unless ``tree`` has the keys, shapes and dtypes
    of ``spec`` in contiguous tensors on one device (``device`` if given).
    Returns that device."""
    if not isinstance(tree, dict) or tree.keys() != spec.keys():
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path}: expected keys {sorted(spec)}, got {got}")
    for k, want in spec.items():
        t, name = tree[k], f"{path}/{k}"
        if isinstance(want, dict):
            device = _check_tree(t, want, device, name)
            continue
        shape, dtype = want
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, other leaves on "
                             f"{device}")
    return device


# ---------------------------------------------------------------------------
# The kernel's argument struct (``MegaArgs`` in ``csrc/megakernel.cu``).
# ---------------------------------------------------------------------------

#: The graph leaves a chunk depends on (``fanin``, ``init_value`` and
#: ``valid`` are read only by ``init_state``); the kernel reads them through
#: :func:`graph_tables`.
GRAPH_LEAVES = ("opcode", "fo_base", "fo_count", "e_dst_pe", "e_dst_slot",
                "e_dst_opidx")
#: The trace leaves in the kernel's order (``MegaArgs::telem``, ``TrLeaf``
#: in ``csrc/megakernel.cu``): every group's, the bucketed ``[buckets, nx,
#: ny]`` leaves first, then the per-PE totals ``[nx, ny]``. A leaf the spec
#: leaves out is a null pointer.
TELEM_LEAVES = TelemetrySpec().leaf_names()
_BUCKETED = frozenset(n for leaves in BUCKETED_LEAVES.values()
                      for n in leaves)
#: int32s of a PE's trace counters in the ``global`` body's scratch
#: (``kTrInts``): the current bucket's eight counts, the five totals and
#: the count of set flags in the PE's RDY row.
TR_INTS = 16
_POINTERS = (
    "slot_info", "edges",
    "pending", "operands", "computed", "value", "remaining",
    "active", "cursor", "cursor_end", "sel_lat", "sel_wait",
    "link_e", "link_s", "cycle", "done",
    "delivered", "noc_deflections", "eject_deflections", "deflections",
    "busy_cycles", "policy_id", "max_cycles", "trace", "link_scratch",
    "sum_scratch", "pe_scratch", "done_host", "done_in", "done_out")
_MEMBER_POINTERS = ("rdy", "ptr", "fifo", "head", "size")
_STRIDES = ("s_plane", "s_pe", "s_words", "s_links")
_INTS = ("nx", "ny", "L", "W", "emax", "K", "B", "n_members",
         "body", "ppt", "threads", "Pp", "S", "smem_bytes", "eject")


class _Member(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _MEMBER_POINTERS]
                + [("kind", ctypes.c_int32), ("unused", ctypes.c_int32)])


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [("members", _Member * MAX_MEMBERS)]
                + [(n, ctypes.c_int64) for n in _STRIDES]
                + [(n, ctypes.c_int32) for n in _INTS]
                + [("buckets", ctypes.c_int32), ("bucket_cycles", ctypes.c_int32),
                   ("s_telem", ctypes.c_int64), ("tr_scratch", ctypes.c_void_p),
                   ("telem", ctypes.c_void_p * len(TELEM_LEAVES))])


def _leaves(tree):
    """The tree's tensors in a fixed order, or None if it is no dict."""
    if not isinstance(tree, dict):
        return None
    out = []
    for v in tree.values():
        if isinstance(v, dict):
            out.extend(_leaves(v))
        else:
            out.append(v)
    return out


def _batch_size(s) -> int:
    """B of a batched state, or -1 (the leaf check then names the fault)."""
    try:
        return int(s["cycle"].shape[0])
    except (TypeError, KeyError, IndexError, AttributeError):
        return -1


def make_mega_chunk_fn(g: overlay.DeviceGraph, cfg: overlay.OverlayConfig,
                       check_every: int, *, names=None, max_cycles=None,
                       with_trace: bool = False, body: str | None = None):
    """Build ``chunk(state) -> state`` running ``check_every`` cycles in one
    kernel launch on a CUDA state, or the plain version on a CPU state (see
    the module docstring). ``with_trace`` makes the chunk return
    ``(state, done_trace)``, the per-cycle done flags ``[K]`` (``[K, B]``
    batched).

    ``names`` (the member policies, in ``policy_id`` order) builds the
    batched form for a state of :func:`overlay.init_batch_state`; with
    ``max_cycles`` (``[B]`` int32 budgets on the state's device) the chunk
    leaves each element that is done or at its budget untouched, the tail's
    freeze. ``body`` forces the kernel's body (see :func:`plan`); by default
    the plan picks it from the shapes.

    On the card, ``chunk(state, done_to=host)`` also has the kernel write
    the chunk's ``done`` flags (``[B]``, or one solo) into ``host``, a
    pinned CPU bool tensor, where the host can read them once the launch
    has completed (behind a CUDA event) with no copy; the chunk's
    ``writes_done`` attribute says it takes ``done_to``.
    ``chunk(state, queued=True)`` is a chunk the host enqueued before it
    read the last chunk's ``done``: where every element was done after the
    last chunk (on the card, as that chunk's kernel left its flags in
    device memory), it leaves the state as it is, as a host reading
    ``done`` first would not have run it."""
    K = int(check_every)
    if K < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    batched = names is not None
    members = tuple(names) if batched else (cfg.scheduler,)
    for name in members:
        if name not in POLICIES:
            raise ValueError(f"no megakernel variant for scheduler "
                             f"{name!r}; have {sorted(POLICIES)}")
    if not 1 <= len(members) <= MAX_MEMBERS or len(set(members)) != len(
            members):
        raise ValueError(f"a batch needs 1 to {MAX_MEMBERS} distinct member "
                         f"policies, got {members}")
    if max_cycles is not None and not batched:
        raise ValueError("max_cycles freezes elements of a batch: pass names")
    eject = eject_variant(cfg)
    traced = cfg.telemetry is not None
    device = _check_tree(dict(g), _graph_spec(g), None, "graph")
    nx, ny, L = g["opcode"].shape
    P, W = nx * ny, L // bitvec.FLAGS_PER_WORD
    how = tables = body_key = None
    if device.type == "cuda":
        how = plan(nx, ny, L, members, body)
        if P * g["e_dst_pe"].shape[-1] >= 2**31:
            raise ValueError("the megakernel's edge offsets are 32-bit: "
                             "fewer than 2**31 edge records a grid")
        tables = graph_tables(g)
        body_key = f"mega_chunk_{how.body}"
    plain = None
    # The kernel updates a state in place, so chunk after chunk of one run
    # passes the same tensors: their check, the argument struct and the
    # scratch are made once, when the leaves differ from the last call's.
    # ``flags`` holds each launch's done flags, by the parity of its launch,
    # for the launch queued behind it.
    last = dict(leaves=None, args=None, trace=None, scratch=None, B=1,
                flags=None, parity=0, launched=False)

    def prepare(s):
        B = _batch_size(s) if batched else None
        _check_tree(s, _state_spec(g, cfg, names if batched else None, B),
                    device, "state")
        B = B if batched else 1
        if max_cycles is not None:
            _check_tree(dict(max_cycles=max_cycles),
                        dict(max_cycles=((B,), torch.int32)), device, "")
        last["B"] = B
        if device.type != "cuda":
            return
        if batched:
            pid = s["sched"]["policy_id"]
            if int(pid.min()) < 0 or int(pid.max()) >= len(members):
                raise ValueError(f"state/sched/policy_id must index the "
                                 f"members {members}")
        trace = torch.empty((K, B) if batched else (K,), dtype=torch.bool,
                            device=device)
        flags = torch.zeros((2, B), dtype=torch.bool, device=device)
        scratch = {}
        if how.body == "global":
            # each element's links of both cycle parities,
            # [B, 2, 2 (E, S), Pp, 8], its RDY summaries and the level above
            # them, [B, S + ceil(S / 32), Pp], and its PEs' registers,
            # [B, Pp, PE_INTS]
            levels = how.summary_words + -(-how.summary_words // 32)
            scratch = {
                name: torch.empty(B * n * how.pp, dtype=torch.int32,
                                  device=device)
                for name, n in (("link_scratch", LINK_INTS),
                                ("sum_scratch", levels),
                                ("pe_scratch", PE_INTS))}
        subs = ([s["sched"][n] for n in members] if batched
                else [s["sched"]])
        telem = s.get("telem", {})
        if telem and how.body == "global":
            # each PE's trace counters between cycles, [B, Pp, TR_INTS]
            scratch["tr_scratch"] = torch.empty(B * TR_INTS * how.pp,
                                                dtype=torch.int32,
                                                device=device)
        tensors = dict(**{k: v for k, v in s.items()
                          if k not in ("sched", "telem")},
                       slot_info=tables[0], edges=tables[1],
                       policy_id=s["sched"]["policy_id"] if batched else None,
                       max_cycles=max_cycles, trace=trace, **scratch)
        args = _Args(**{n: None if tensors.get(n) is None
                        else tensors[n].data_ptr() for n in _POINTERS},
                     nx=nx, ny=ny, L=L, W=W, emax=g["e_dst_pe"].shape[-1],
                     K=K, B=B, n_members=len(members),
                     body=_BODIES[how.body], ppt=how.ppt,
                     threads=how.threads, Pp=how.pp, S=how.summary_words,
                     smem_bytes=how.smem_bytes)
        if telem:
            tel = cfg.telemetry
            args.buckets, args.bucket_cycles = tel.buckets, tel.bucket_cycles
            args.s_telem = tel.buckets * P
            if "tr_scratch" in scratch:
                args.tr_scratch = scratch["tr_scratch"].data_ptr()
            for i, n in enumerate(TELEM_LEAVES):
                if n in telem:
                    args.telem[i] = telem[n].data_ptr()
        for m, (name, sub) in enumerate(zip(members, subs)):
            args.members[m] = _Member(
                kind=POLICIES[name],
                **{n: sub[n].data_ptr() if n in sub else None
                   for n in _MEMBER_POINTERS})
        if batched:
            # element strides of the [B, ...] leaves (contiguous, checked)
            args.s_plane = s["pending"].stride(0)
            args.s_pe = s["active"].stride(0)
            args.s_words = P * W
            args.s_links = s["link_e"].stride(0)
        last.update(args=args, addr=ctypes.addressof(args), trace=trace,
                    scratch=scratch, flags=flags, parity=0, launched=False)

    def chunk(s, done_to=None, queued=False):
        nonlocal plain
        leaves = _leaves(s)
        prev = last["leaves"]
        if (leaves is None or prev is None or len(leaves) != len(prev)
                or not all(map(operator.is_, leaves, prev))):
            last["leaves"] = None
            prepare(s)
            last["leaves"] = leaves
        if device.type == "cpu":
            if queued and bool(s["done"].all()):
                return ((s, s["done"].expand(K, *s["done"].shape).clone())
                        if with_trace else s)
            if plain is None:
                plain = (mega_batch_chunk_plain(g, cfg, K, members,
                                                with_trace=True,
                                                max_cycles=max_cycles)
                         if batched else
                         mega_chunk_plain(g, cfg, K, with_trace=True))
            s, trace = plain(s)
            return (s, trace) if with_trace else s
        if device.type != "cuda":
            raise ValueError(f"no megakernel for device {device}")
        args, trace = last["args"], last["trace"]
        if with_trace:        # the caller keeps it: a fresh one per call
            trace = torch.empty_like(trace)
            args.trace = trace.data_ptr()
        if done_to is not None:
            if (done_to.device.type != "cpu" or not done_to.is_pinned()
                    or done_to.dtype != torch.bool
                    or done_to.numel() != last["B"]):
                raise ValueError(f"done_to must be a pinned CPU bool tensor "
                                 f"of {last['B']} elements")
            args.done_host = done_to.data_ptr()
        if queued and not last["launched"]:
            raise ValueError("a queued chunk follows a chunk on the same "
                             "state")
        q = last["parity"]
        args.done_out = last["flags"][q].data_ptr()
        args.done_in = last["flags"][1 - q].data_ptr() if queued else None
        key = "mega_chunk_batched" if batched else "mega_chunk"
        fn = _build.library(SOURCE).mega_chunk
        launches[key] += 1
        launches[body_key] += 1
        if traced:
            launches["mega_chunk_traced"] += 1
        # The launch goes to the current stream of the state's device (the
        # raw handle, as torch's own generated code reads it).
        if torch.cuda.current_device() == device.index:
            rc = fn(last["addr"], eject,
                    torch._C._cuda_getCurrentRawStream(device.index))
        else:
            with torch.cuda.device(device):
                rc = fn(last["addr"], eject,
                        torch._C._cuda_getCurrentRawStream(device.index))
        # The launch copied the struct; later calls set their own.
        if with_trace:
            args.trace = last["trace"].data_ptr()
        args.done_host = args.done_in = None
        if rc != 0:
            raise RuntimeError(f"{key} kernel launch failed: CUDA error {rc}")
        last.update(parity=1 - q, launched=True)
        return (s, trace) if with_trace else s

    chunk.writes_done = True
    return chunk
