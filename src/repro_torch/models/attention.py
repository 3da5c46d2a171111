"""Blockwise (flash) attention of the model stack.

The counterpart of the reference package's ``models/attention.py``, with its
layout and semantics: q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] (token-major,
GQA by head grouping, kv heads never repeated), causal masking aligned at the
ends (the decode convention), and ``kv_len`` bounding the valid cache
positions of each batch row. On a CUDA tensor this launches the hand-written
kernel (:mod:`repro_torch.kernels.flash_attention`), the port of the
reference's Pallas kernel, which that module names its drop-in replacement on
the accelerator; on a CPU tensor it runs the kernel's plain version.
"""
from __future__ import annotations

from ..kernels import flash_attention as fa


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None, q_chunk: int = 512,
                        kv_chunk: int = 1024, kv_len=None,
                        differentiable: bool = False):
    """Returns [B, Tq, Hq, D] attention output (dtype of q, f32
    accumulation).

    kv_len: optional [] or [B] ints, the number of valid kv positions (cache
    fill level); defaults to Tkv. The last q token attends up to kv position
    ``kv_len - 1``, and the causal offset is ``kv_len - Tq``.

    ``q_chunk`` is unused (the kernel tiles the rows itself); ``kv_chunk`` is
    the plain version's chunk. ``differentiable=True``, the reference's
    training form, is not ported yet.
    """
    del q_chunk
    if differentiable:
        raise NotImplementedError(
            "blockwise_attention(differentiable=True), the training form, is "
            "not ported yet (ROADMAP queue 1 item 12g)")
    return fa.attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len,
                        kv_chunk=kv_chunk)
