"""The overlay's K-cycle chunk in one launch (the "megakernel"): the CUDA
kernel and its plain torch version.

:func:`make_mega_chunk_fn` replaces the Pallas TPU kernel of the reference
package's ``kernels/megakernel.py`` (``make_mega_chunk_fn``), solo form: it
builds ``chunk(state) -> state`` running ``check_every`` cycles of
:func:`repro_torch.core.overlay.make_cycle_fn` back to back, with the
reference's chunk repair of ``cycle`` and ``done``. The chunk

  * on a state on the CPU runs the plain version, :func:`mega_chunk_plain`
    (the ``"tensor"`` engine's cycle, chunked by
    :func:`repro_torch.core.overlay.make_chunk_fn`);
  * on a state on a CUDA device launches the kernel of
    ``csrc/megakernel.cu`` once on the current stream, or raises. There is
    no fallback. The kernel updates every state tensor in place and the
    chunk returns the same dict.

Every graph and state leaf is checked (one device, contiguous, the dtype
and shape that ``device_graph``/``init_state`` give it) before the dispatch,
so a malformed state raises ``ValueError`` on either device. A state whose
tensors are the last call's (the kernel updates them in place) is not
checked again.

:data:`launches` counts kernel launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import bitvec, noc, overlay
from . import _build

SOURCE = "megakernel.cu"

#: Kernel launches since the last :func:`reset_launches`.
launches: dict[str, int] = {"mega_chunk": 0}

#: Compile-time variants of the kernel: the policy's pick and the eject
#: arbitration (``csrc/megakernel.cu``'s ``Policy`` and ``Eject``).
POLICIES = {"ooo": 0, "inorder": 1, "scan": 2, "lru_flat": 2}
_EJECT_CAP1 = {"n_first": 0, "priority": 1}
_EJECT_CAP2 = 2


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


def _state_spec(g, cfg):
    nx, ny, L = g["opcode"].shape
    i32, plane, pe = torch.int32, (nx, ny, L), (nx, ny)
    rdy = ((nx, ny, L // bitvec.FLAGS_PER_WORD), i32)
    sched = {"ooo": dict(rdy=rdy),
             "inorder": dict(fifo=(plane, i32), head=(pe, i32),
                             size=(pe, i32))}.get(
        cfg.scheduler, dict(rdy=rdy, ptr=(pe, i32)))
    links = ((len(noc.PKT_FIELDS), nx, ny), i32)
    return dict(
        pending=(plane, i32), operands=((*plane, 2), torch.float32),
        computed=(plane, torch.bool), value=(plane, torch.float32),
        remaining=((), i32), sched=sched,
        active=(pe, i32), cursor=(pe, i32), cursor_end=(pe, i32),
        sel_lat=((), i32), sel_wait=(pe, i32), link_e=links, link_s=links,
        cycle=((), i32), done=((), torch.bool),
        **{k: ((), i32) for k in overlay.STAT_COUNTERS})


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

#: The graph leaves the kernel reads (``fanin``, ``init_value`` and ``valid``
#: are read only by ``init_state``).
GRAPH_LEAVES = ("opcode", "fo_base", "fo_count", "e_dst_pe", "e_dst_slot",
                "e_dst_opidx")
_POINTERS = GRAPH_LEAVES + (
    "pending", "operands", "computed", "value", "remaining",
    "rdy", "ptr", "fifo", "head", "size",
    "active", "cursor", "cursor_end", "sel_lat", "sel_wait",
    "link_e", "link_s", "cycle", "done",
    "delivered", "noc_deflections", "eject_deflections", "deflections",
    "busy_cycles", "trace", "link_scratch")
_INTS = ("nx", "ny", "L", "W", "emax", "K")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int32) for n in _INTS])


def _leaves(s):
    """The state's tensors in a fixed order, or None if it lacks a key."""
    try:
        return ([v for k, v in s.items() if k != "sched"]
                + list(s["sched"].values()))
    except (AttributeError, KeyError):
        return None


def make_mega_chunk_fn(g: overlay.DeviceGraph, cfg: overlay.OverlayConfig,
                       check_every: int, *, with_trace: bool = False):
    """Build ``chunk(state) -> state`` running ``check_every`` cycles in one
    kernel launch on a CUDA state, or the plain version on a CPU state (see
    the module docstring). ``with_trace`` makes the chunk return
    ``(state, done_trace)``, the per-cycle done flags ``[K]`` bool."""
    K = int(check_every)
    if K < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    policy = POLICIES.get(cfg.scheduler)
    if policy is None:
        raise ValueError(f"no megakernel variant for scheduler "
                         f"{cfg.scheduler!r}; have {sorted(POLICIES)}")
    eject = eject_variant(cfg)
    device = _check_tree(dict(g), _graph_spec(g), None, "graph")
    spec = _state_spec(g, cfg)
    nx, ny, L = g["opcode"].shape
    dims = dict(nx=nx, ny=ny, L=L, W=L // bitvec.FLAGS_PER_WORD,
                emax=g["e_dst_pe"].shape[-1], K=K)
    plain = None
    # The kernel updates a state in place, so chunk after chunk of one run
    # passes the same tensors: their check, the argument struct and the
    # scratch are made once, when the leaves differ from the last call's.
    last = dict(leaves=None, args=None, trace=None, scratch=None)

    def prepare(s):
        _check_tree(s, spec, device, "state")
        if device.type != "cuda":
            return
        trace = torch.empty(K, dtype=torch.bool, device=device)
        # the links of both cycle parities: [2, 2 (E, S), 6, P]
        scratch = torch.empty(2 * 2 * len(noc.PKT_FIELDS) * nx * ny,
                              dtype=torch.int32, device=device)
        tensors = dict(g, **{k: v for k, v in s.items() if k != "sched"},
                       **s["sched"], trace=trace, link_scratch=scratch)
        last.update(args=_Args(
            **{n: tensors[n].data_ptr() if tensors.get(n) is not None
               else None for n in _POINTERS}, **dims),
            trace=trace, scratch=scratch)

    def chunk(s):
        nonlocal plain
        leaves = _leaves(s)
        prev = last["leaves"]
        if (leaves is None or prev is None or len(leaves) != len(prev)
                or any(a is not b for a, b in zip(leaves, prev))):
            last["leaves"] = None
            prepare(s)
            last["leaves"] = leaves
        if device.type == "cpu":
            if plain is None:
                plain = mega_chunk_plain(g, cfg, K, with_trace=True)
            s, trace = plain(s)
            return (s, trace) if with_trace else s
        if device.type != "cuda":
            raise ValueError(f"no megakernel for device {device}")
        args, trace = last["args"], last["trace"]
        if with_trace:        # the caller keeps it: a fresh one per call
            trace = torch.empty(K, dtype=torch.bool, device=device)
            args.trace = trace.data_ptr()
        with torch.cuda.device(device):
            fn = _build.library(SOURCE).mega_chunk
            launches["mega_chunk"] += 1
            rc = fn(ctypes.addressof(args), policy, eject,
                    torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mega_chunk kernel launch failed: CUDA "
                               f"error {rc}")
        return (s, trace) if with_trace else s

    return chunk
