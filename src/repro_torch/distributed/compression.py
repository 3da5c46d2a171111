"""Gradient compression with error feedback: the counterpart of the
reference package's ``distributed/compression.py``.

int8 per-tensor quantized gradient all-reduce: each worker quantizes
(grad + error_residual) to int8 with a shared per-tensor scale, all-reduces
the int8 payload in int32 (a sum of <= 4096 workers cannot overflow), and
dequantizes. The quantization error is carried to the next step (error
feedback), which keeps convergence intact (1-bit Adam / EF-SGD lineage).
Cuts gradient all-reduce traffic 4x against float32, 2x against bfloat16.

Usable two ways:
  * ``compress_roundtrip`` — pure single-process form (tests, unit math);
  * ``make_compressed_psum(group)`` — the mean of the gradients over a
    process group's ranks (the reference's ``shard_map`` axis), in place of
    a float all-reduce across the data axis.

The arithmetic is the reference's in its order (``x / s``, round half to
even, clip, ``* s``; the mean ``total * s / n``; the psum's residual as
the single rounding XLA's fused multiply-add gives), so the results are its
bits. A tree is nested dicts, lists and tuples of tensors.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import torch
import torch.distributed as dist

from . import sharding


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, Mapping):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _scale(x):
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize(q, scale):
    return q.to(torch.float32) * scale


class _Pair(NamedTuple):
    first: torch.Tensor
    second: torch.Tensor


def _split(tree):
    """A tree of :class:`_Pair` leaves -> (tree of firsts, tree of
    seconds)."""
    if isinstance(tree, _Pair):
        return tree
    if isinstance(tree, Mapping):
        parts = {k: _split(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    parts = [_split(v) for v in tree]
    return (type(tree)(p[0] for p in parts), type(tree)(p[1] for p in parts))


def compress_roundtrip(grads, err):
    """Quantize (g + err) -> int8 -> dequantize; returns (g_hat, new_err).

    Per leaf. The caller sums g_hat across workers (all-reduce)."""
    def leaf(g, e):
        x = g.to(torch.float32) + e
        s = _scale(x)
        g_hat = dequantize(quantize(x, s), s)
        return _Pair(g_hat, x - g_hat)

    return _split(_map(leaf, grads, err))


def init_error(params):
    """Zero float32 residuals shaped as ``params`` (a tree of tensors)."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def make_compressed_psum(group=None):
    """Returns psum_c(grads, err) -> (mean_grads, new_err), the mean over
    the ranks of ``group`` (None: the world), every rank calling it with
    its own trees. The shared scale is the ranks' largest (an all-reduce of
    MAX); the int8 payload is all-reduced as int32."""
    def psum_c(grads, err):
        n = dist.get_world_size(group)

        def leaf(g, e):
            x = g.to(torch.float32) + e
            # shared scale: max over workers so the int8 grids agree
            s = sharding.all_reduce(_scale(x), group, dist.ReduceOp.MAX)
            q = quantize(x, s)
            total = sharding.all_reduce(q.to(torch.int32), group)
            mean = total.to(torch.float32) * s / n
            # XLA contracts x - q * s into one fused multiply-add (a single
            # rounding). In float64 the product of an int8 and a float32 is
            # exact and so is the difference, |x - q s| <= s / 2 apart from
            # q = 0: one rounding to float32 gives the same bits.
            new = (x.double() - q.double() * s.double()).float()
            return _Pair(mean, new)

        return _split(_map(leaf, grads, err))

    return psum_c
