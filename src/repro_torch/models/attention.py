"""Blockwise (flash) attention of the model stack.

The counterpart of the reference package's ``models/attention.py``, with its
layout and semantics: q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] (token-major,
GQA by head grouping, kv heads never repeated), causal masking aligned at the
ends (the decode convention), and ``kv_len`` bounding the valid cache
positions of each batch row.

Two forms, picked by the caller:

  * ``differentiable=False`` (serving and scoring under ``torch.no_grad()``):
    on a CUDA tensor it launches the hand-written kernel
    (:mod:`repro_torch.kernels.flash_attention`), the port of the
    reference's Pallas kernel, which that module names its drop-in
    replacement on the accelerator; on a CPU tensor it runs the kernel's
    plain version. The kernel has no backward and refuses a tensor that
    needs a gradient.
  * ``differentiable=True``, the reference's training form: torch ops under
    autograd, on any device. The q-chunk loop is unrolled in Python and each
    q chunk scans a static number of kv chunks, so fully masked causal
    blocks cost nothing; the online softmax accumulates in float32.

A forward in mode ``"train"`` takes the training form exactly when
gradients are enabled (:func:`training_form`), so every serve run launches
the kernel and every training step runs the differentiable form; nothing
falls back from one to the other.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa

NEG = -1e30                 # the reference's mask value


def training_form() -> bool:
    """Whether a forward in mode ``"train"`` takes the differentiable form:
    when gradients are enabled. Under ``torch.no_grad()`` it launches the
    kernel (on the card) instead."""
    return torch.is_grad_enabled()


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None, q_chunk: int = 512,
                        kv_chunk: int = 1024, kv_len=None,
                        differentiable: bool = False):
    """Returns [B, Tq, Hq, D] attention output (dtype of q, f32
    accumulation).

    kv_len: optional [] or [B] ints, the number of valid kv positions (cache
    fill level); defaults to Tkv. The last q token attends up to kv position
    ``kv_len - 1``, and the causal offset is ``kv_len - Tq``.

    ``differentiable=True`` runs the training form (:func:`train_attention`)
    with both chunks; otherwise ``q_chunk`` is unused (the kernel tiles the
    rows itself) and ``kv_chunk`` is the plain version's chunk.
    """
    if differentiable:
        return train_attention(q, k, v, causal=causal, scale=scale,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               kv_len=kv_len)
    return fa.attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len,
                        kv_chunk=kv_chunk)


def train_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, q_chunk: int = 512,
                    kv_chunk: int = 1024, kv_len=None):
    """The reference's ``blockwise_attention(..., differentiable=True)`` in
    torch ops. Tq and Tkv are padded to multiples of ``cq = min(q_chunk,
    Tq)`` and ``ck = min(kv_chunk, Tkv)``; q chunk i scans kv chunks ``0 ..
    n - 1`` with ``n = max(1, min(nk, ceil(((i + 1) cq + Tkv - Tq) / ck)))``
    when causal, else all ``nk``. Scores, the running max and sum and the
    accumulator are float32; masked scores are ``NEG``."""
    b, tq, hq, d = q.shape
    tkv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    rep = hq // hkv
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    dev = q.device
    if kv_len is None:
        kv_len_b = torch.full((b,), tkv, dtype=torch.int64, device=dev)
    else:
        kv_len_b = torch.as_tensor(kv_len, device=dev).to(torch.int64)
        kv_len_b = kv_len_b.expand(b) if kv_len_b.dim() == 0 else kv_len_b
    cq, ck = min(q_chunk, tq), min(kv_chunk, tkv)
    qpad, kpad = -tq % cq, -tkv % ck
    q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    k = F.pad(k, (0, 0, 0, 0, 0, kpad))
    v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    nq, nk = (tq + qpad) // cq, (tkv + kpad) // ck

    # [B, T, H, D] -> [B, Hkv, (rep,) T, D], in float32 once.
    kT = k.transpose(1, 2).float()
    vT = v.transpose(1, 2).float()
    qT = q.transpose(1, 2).reshape(b, hkv, rep, tq + qpad, d).float()
    offset = kv_len_b - tq                       # ends-aligned causal offset
    outs = []
    for i in range(nq):
        n = (max(1, min(nk, math.ceil(((i + 1) * cq + (tkv - tq)) / ck)))
             if causal else nk)
        qc = qT[:, :, :, i * cq:(i + 1) * cq]                 # [B,G,R,cq,D]
        qpos = (i * cq + torch.arange(cq, device=dev))[None] + offset[:, None]
        m = torch.full((b, hkv, rep, cq), NEG, device=dev)
        l = torch.zeros((b, hkv, rep, cq), device=dev)
        acc = torch.zeros((b, hkv, rep, cq, d), device=dev)
        for j in range(n):
            kc = kT[:, :, None, j * ck:(j + 1) * ck]          # [B,G,1,ck,D]
            vc = vT[:, :, None, j * ck:(j + 1) * ck]
            sc = (qc @ kc.transpose(-1, -2)) * s              # [B,G,R,cq,ck]
            kpos = j * ck + torch.arange(ck, device=dev)
            mask = (kpos[None] < kv_len_b[:, None])[:, None, :]   # [B,1,ck]
            if causal:
                mask = mask & (qpos[:, :, None] >= kpos[None, None, :])
            sc = torch.where(mask[:, None, None], sc, NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vc
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(b, hq, tq + qpad, d)
    return out.transpose(1, 2)[:, :tq]
