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

#: Kernel launches since the last :func:`reset_launches`.
launches: dict[str, int] = {"anneal": 0}

#: Rungs a ladder may have (the kernel's shared-memory tables).
MAX_REPLICAS = 1024

anneal_plain = place_anneal.anneal_plain


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
                   pressure_weight: int):
    """``Q`` ladders of ``R`` rungs: ``init_pe`` [Q, N] int32, the item
    set's padded incidence tables ``nbr``/``w_inc``/``is_out`` [N, D]
    (int32, int32, bool), ``w_node`` [N] int32, ``thresholds`` [Q, R]
    int64, ``keys`` [Q, 2] int64 (each ladder's root key words).

    Returns (``best_pe`` [Q, R, N] int32, ``best_cost`` [Q, R] int64,
    ``init_cost`` [Q] int64), equal to the reference's on every device."""
    Q, N, D, R = _check(init_pe, nbr, w_inc, is_out, w_node, thresholds,
                        keys)
    knobs = dict(nx=nx, ny=ny, rounds=rounds, steps=steps,
                 pressure_weight=pressure_weight)
    if init_pe.device.type == "cpu":
        return anneal_plain(init_pe, nbr, w_inc, is_out, w_node, thresholds,
                            keys, **knobs)
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
    fn = _build.library(SOURCE).anneal_rounds
    launches["anneal"] += 1
    with torch.cuda.device(init_pe.device):
        rc = fn(ctypes.byref(args), Q,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"anneal kernel launch failed: CUDA error {rc}")
    return best_pe, best_cost, init_cost
