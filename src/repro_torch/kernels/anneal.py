"""The placement annealer's rounds in one launch: the CUDA kernel and its
plain torch version.

:func:`anneal_ladders` runs ``Q`` independent parallel-tempering ladders of
``R`` replicas over one item set — the reference package's
``place/anneal.py::_anneal_jit`` (an XLA scan of ``rounds`` x (``steps``
proposals, best tracking, exchange, loads recomputed), vmapped over the
replicas and, for ``anneal_tables_many``, over the ladders). That is not a
TPU kernel in the reference; on the card it is this hand-written one
(``csrc/anneal.cu``), because a step is serial in the state and draws
twelve Threefry blocks, which eager torch ops (~1,000 a step) and captured
graphs (~10^8 nodes a search) cannot carry. The wrapper

  * on tensors on the CPU runs :func:`repro_torch.place.anneal.anneal_plain`
    (torch ops over ``[Q, R, N]``, the key chain of
    :mod:`repro_torch.core.prng`);
  * on tensors on a CUDA device builds each ladder's start (the init on
    every rung, its loads and cost) with torch ops and the rungs' keys on
    the host, and launches the kernel once on the current stream, or
    raises. There is no fallback.

The surrogate-guided search (the reference's ``_anneal_guided_jit``, also
an XLA scan) is the kernel's ``GUIDED`` instantiation: each slot also
carries its guide state (per-PE loads, counts, inject and eject, the depth
histogram, the rings and the 29 features, int64, in device memory), built
with torch ops (``state_init`` on the card); on the CPU the wrapper runs
:func:`repro_torch.place.anneal.anneal_guided_plain`.

:data:`launches` counts kernel launches, so a run can show that its search
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import prng
from ..place import anneal as place_anneal
from . import _build

SOURCE = "anneal.cu"

#: Kernel launches since the last :func:`reset_launches` (the guided
#: search's under ``"anneal_guided"``).
launches: dict[str, int] = {"anneal": 0, "anneal_guided": 0}

#: Rungs a ladder may have (the kernel's shared-memory tables).
MAX_REPLICAS = 1024

anneal_plain = place_anneal.anneal_plain
anneal_guided_plain = place_anneal.anneal_guided_plain


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class _Args(ctypes.Structure):
    _fields_ = [(n, _P) for n in (
        "nbr", "w_inc", "is_out", "w_node", "pe", "load", "cost", "keys",
        "thresh", "best_pe", "best_cost")] + [
        (n, _I) for n in ("n", "d", "nx", "ny", "replicas", "rounds",
                          "steps")] + [("pw", _L)]


class _GuideArgs(ctypes.Structure):
    _fields_ = [(n, _P) for n in (
        "nbr", "is_out", "w_inc", "c_inc", "u_inc", "w_node", "n_unit",
        "w_bucket", "gamma", "state", "evals")] + [("margin", _L)] + [
        (n, _I) for n in ("d", "every")]


def _check(init_pe, nbr, w_inc, is_out, w_node, thresholds, keys):
    dev = init_pe.device
    Q, N = init_pe.shape if init_pe.dim() == 2 else (None, None)
    if Q is None:
        raise ValueError(f"init_pe must be [Q, N], got {tuple(init_pe.shape)}")
    D = nbr.shape[-1] if nbr.dim() == 2 else None
    R = thresholds.shape[-1] if thresholds.dim() == 2 else None
    spec = dict(init_pe=(init_pe, (Q, N), torch.int32),
                nbr=(nbr, (N, D), torch.int32),
                w_inc=(w_inc, (N, D), torch.int32),
                is_out=(is_out, (N, D), torch.bool),
                w_node=(w_node, (N,), torch.int32),
                thresholds=(thresholds, (Q, R), torch.int64),
                keys=(keys, (Q, 2), torch.int64))
    for name, (t, shape, dtype) in spec.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, init_pe on {dev}")
    if N < 1 or R < 1:
        raise ValueError("an anneal needs at least one item and one replica")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no anneal kernel for device {dev}")
    return Q, N, D, R


def anneal_ladders(init_pe, nbr, w_inc, is_out, w_node, thresholds, keys, *,
                   nx: int, ny: int, rounds: int, steps: int,
                   pressure_weight: int, guide=None, q_margin: int = 0,
                   guide_every: int = 1):
    """``Q`` ladders of ``R`` rungs: ``init_pe`` [Q, N] int32, the item
    set's padded incidence tables ``nbr``/``w_inc``/``is_out`` [N, D]
    (int32, int32, bool), ``w_node`` [N] int32, ``thresholds`` [Q, R]
    int64, ``keys`` [Q, 2] int64 (each ladder's root key words).

    Returns (``best_pe`` [Q, R, N] int32, ``best_cost`` [Q, R] int64,
    ``init_cost`` [Q] int64), equal to the reference's on every device.

    With ``guide`` (:class:`repro_torch.surrogate.delta.GuideArrays` for the
    same items and grid) the search is the surrogate-guided one
    (:func:`repro_torch.place.anneal.anneal_guided_plain`: the gate
    ``dscore <= q_margin``, int64, on the steps ``j % guide_every == 0`` of
    each round), and the returns gain ``evals`` [Q, R] int64, the promising
    proposals of each rung. The ladders share the guide and the margin."""
    Q, N, D, R = _check(init_pe, nbr, w_inc, is_out, w_node, thresholds,
                        keys)
    knobs = dict(nx=nx, ny=ny, rounds=rounds, steps=steps,
                 pressure_weight=pressure_weight)
    if guide is not None:
        if guide_every < 1:
            raise ValueError(f"guide_every must be >= 1, got {guide_every}")
        if guide.w_node.shape[0] != N:
            raise ValueError(f"the guide is for {guide.w_node.shape[0]} "
                             f"items, the search places {N}")
        if not -2 ** 63 <= int(q_margin) < 2 ** 63:
            raise ValueError(f"q_margin {q_margin} is not an int64")
    if init_pe.device.type == "cpu":
        if guide is None:
            return anneal_plain(init_pe, nbr, w_inc, is_out, w_node,
                                thresholds, keys, **knobs)
        return anneal_guided_plain(init_pe, nbr, w_inc, is_out, w_node,
                                   thresholds, keys, guide, int(q_margin),
                                   guide_every=int(guide_every), **knobs)
    if R > MAX_REPLICAS:
        raise ValueError(f"the anneal kernel takes at most {MAX_REPLICAS} "
                         f"replicas, got {R}")
    if max(N, nx * ny) >= 2 ** 31 or N * D >= 2 ** 62:
        raise ValueError("the anneal kernel's item and PE ids are 32-bit")
    pe, load, cost = place_anneal.ladder_start(
        init_pe, nbr, w_inc, is_out, w_node, R, nx, ny, pressure_weight)
    init_cost = cost[:, 0].clone()
    best_pe, best_cost = pe.clone(), cost.clone()
    # the rungs' keys: a few hundred tiny ops, on the host (uint32 bits)
    rung_keys = prng.split(keys.cpu(), R).to(torch.int32).to(keys.device)
    out = dict(nbr=nbr.contiguous(), w_inc=w_inc.contiguous(),
               is_out=is_out.contiguous(), w_node=w_node.contiguous(),
               pe=pe, load=load, cost=cost, keys=rung_keys,
               thresh=thresholds.contiguous(), best_pe=best_pe,
               best_cost=best_cost)
    args = _Args(**{k: v.data_ptr() for k, v in out.items()},
                 n=N, d=D, nx=nx, ny=ny, replicas=R, rounds=rounds,
                 steps=steps, pw=int(pressure_weight))
    lib = _build.library(SOURCE)
    with torch.cuda.device(init_pe.device):
        stream = torch.cuda.current_stream().cuda_stream
        if guide is None:
            launches["anneal"] += 1
            rc = lib.anneal_rounds(ctypes.byref(args), Q, stream)
        else:
            gargs, keep = _guide_args(guide, pe, nx, ny, int(q_margin),
                                      int(guide_every))
            launches["anneal_guided"] += 1
            rc = lib.anneal_guided_rounds(ctypes.byref(args),
                                          ctypes.byref(gargs), Q, stream)
    if rc != 0:
        raise RuntimeError(f"anneal kernel launch failed: CUDA error {rc}")
    if guide is None:
        return best_pe, best_cost, init_cost
    return best_pe, best_cost, init_cost, keep["evals"]


def _guide_args(guide, pe, nx: int, ny: int, q_margin: int, every: int):
    """The guided kernel's arguments: the guide's tables on ``pe``'s device
    and every slot's start guide state (``state_init`` of the ladders'
    start placements ``pe`` [Q, R, N], on the card). Returns the ctypes
    struct and the tensors it points at (kept alive by the caller)."""
    from ..surrogate import delta

    ga = delta.to_device(guide, pe.device)
    st = delta.state_init(ga, pe, nx=nx, ny=ny)
    state = torch.cat([st.loads, st.counts, st.inject, st.eject,
                       st.lvl.flatten(-2), st.ring_x, st.ring_y, st.feats],
                      -1).contiguous()
    keep = dict(nbr=ga.nbr.to(torch.int32).contiguous(),
                is_out=ga.out_inc.contiguous(),
                w_inc=ga.w_inc.contiguous(), c_inc=ga.c_inc.contiguous(),
                u_inc=ga.u_inc.contiguous(), w_node=ga.w_node.contiguous(),
                n_unit=ga.n_unit.contiguous(),
                w_bucket=ga.w_bucket.contiguous(),
                gamma=ga.gamma_q.contiguous(), state=state,
                evals=torch.zeros(pe.shape[:2], dtype=torch.int64,
                                  device=pe.device))
    gargs = _GuideArgs(**{k: v.data_ptr() for k, v in keep.items()},
                       margin=q_margin, d=int(ga.nbr.shape[-1]), every=every)
    return gargs, keep
