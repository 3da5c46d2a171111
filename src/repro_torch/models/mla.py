"""DeepSeek-V2 Multi-head Latent Attention (MLA), as an ``nn.Module``.

The counterpart of the reference package's ``models/mla.py``. The prefill
(and the forward of mode ``"train"``) materialises per-head K and V from the compressed
latent ``c_kv`` (``kv_lora_rank`` wide), joins ``[nope, rope]`` to the qk
width (192 at DeepSeek-V2-Lite), zero-pads v from 128 to that width and runs
the blockwise attention with ``scale = qk_width ** -0.5``: on a CUDA tensor
that launches the flash-attention kernel at head_dim 192. The decode step
uses the **absorbed** form, as the reference does: ``W_uk`` is folded into
the query and the scores run against the ``[T, kv_lora + rope_dim]`` latent
cache in float32, divided by ``sqrt(float32(qk_width))``; it launches no
kernel. The two scales are written as the reference writes them. In mode
``"train"`` with gradients enabled the attention takes the training form
(:func:`.attention.training_form`), as the reference's ``differentiable=True``
does; under ``torch.no_grad()`` the kernel.

The cache entry is ``{"ckv": [b, L, kv_lora_rank], "kr": [b, L,
rope_head_dim]}``, updated in place.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import blocks as B
from .attention import blockwise_attention, training_form
from .common import ModelConfig, apply_rope, rmsnorm


class _RMSNorm(nn.Module):
    """``w`` (ones): the latent's rmsnorm, whatever ``cfg.norm`` is."""

    def __init__(self, d, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.eps = cfg.norm_eps
        self.w = B._param((d,), cfg.torch_dtype, device, fill=1.0)

    def forward(self, x):
        return rmsnorm(x, self.w, self.eps)


class MLA(nn.Module):
    """``wq``, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``: the
    reference's parameter paths (each a ``.w``)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        m, h, d = cfg.mla, cfg.num_heads, cfg.d_model
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.wq = B.Dense(d, h * (m.nope_head_dim + m.rope_head_dim), cfg, **kw)
        self.w_dkv = B.Dense(d, m.kv_lora_rank + m.rope_head_dim, cfg, **kw)
        self.kv_norm = _RMSNorm(m.kv_lora_rank, cfg, device=device)
        self.w_uk = B.Dense(m.kv_lora_rank, h * m.nope_head_dim, cfg, **kw)
        self.w_uv = B.Dense(m.kv_lora_rank, h * m.v_head_dim, cfg, **kw)
        self.wo = B.Dense(h * m.v_head_dim, d, cfg, **kw)

    def forward(self, x, aux):
        """train (no cache), prefill (writes the latent cache from position
        0) or decode (writes position ``cache_len``). Returns (out,
        extras)."""
        mode = aux["mode"]
        if mode == "train":
            return apply_seq(self, self.cfg, x, aux["positions"],
                             differentiable=training_form()), {}
        if mode == "prefill":
            cache = aux["cache"]
            out, latent = apply_seq(self, self.cfg, x, aux["positions"],
                                    return_cache=True)
            t = x.shape[1]
            for name in ("ckv", "kr"):
                cache[name][:, :t].copy_(latent[name])
            return out, {"cache": cache}
        if mode == "decode":
            return apply_decode(self, self.cfg, x, aux["cache"],
                                aux["cache_len"])
        raise ValueError(f"unknown mode {mode!r}")


def _project_q(params: MLA, cfg, x, positions):
    m = cfg.mla
    b, t, _ = x.shape
    q = params.wq(x).reshape(b, t, cfg.num_heads,
                             m.nope_head_dim + m.rope_head_dim)
    qn, qr = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    qr = apply_rope(qr.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    return qn, qr


def _latent(params: MLA, cfg, x, positions):
    """-> ckv [b, t, kv_lora_rank] (rmsnormed), kr [b, t, rope_head_dim]
    (RoPE on the single shared head)."""
    m = cfg.mla
    ckv, kr = params.w_dkv(x).split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    ckv = params.kv_norm(ckv)
    kr = apply_rope(kr[:, None], positions, cfg.rope_theta)[:, 0]
    return ckv, kr


def apply_seq(params: MLA, cfg: ModelConfig, x, positions, *,
              return_cache=False, differentiable=False):
    """Full-sequence MLA. x: [b, t, d] -> out (and the latent cache);
    ``differentiable`` picks the attention's training form."""
    m = cfg.mla
    h = cfg.num_heads
    b, t, _ = x.shape
    qn, qr = _project_q(params, cfg, x, positions)
    ckv, kr = _latent(params, cfg, x, positions)
    kn = params.w_uk(ckv).reshape(b, t, h, m.nope_head_dim)
    v = params.w_uv(ckv).reshape(b, t, h, m.v_head_dim)
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr[:, :, None, :].expand(b, t, h, m.rope_head_dim)],
                   dim=-1)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    out = _attn_qkv(qf, kf, v, scale, cfg, differentiable)
    out = params.wo(out.reshape(b, t, h * m.v_head_dim))
    if return_cache:
        return out, {"ckv": ckv, "kr": kr}
    return out


def _attn_qkv(qf, kf, v, scale: float, cfg, differentiable=False):
    """Causal blockwise attention where v is narrower than q and k: v is
    zero-padded to their width, the output cut back to v's."""
    dqk, dv = qf.shape[-1], v.shape[-1]
    vpad = torch.nn.functional.pad(v, (0, dqk - dv)) if dv < dqk else v
    out = blockwise_attention(qf, kf, vpad, causal=True, scale=scale,
                              q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                              differentiable=differentiable)
    return out[..., :dv]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                           dtype=cfg.torch_dtype, device=device),
        "kr": torch.zeros((batch, max_len, m.rope_head_dim),
                          dtype=cfg.torch_dtype, device=device),
    }


def apply_decode(params: MLA, cfg: ModelConfig, x, cache, cache_len):
    """Absorbed-matrix single-token decode. x: [b, 1, d]; ``cache_len`` an
    int (tokens already in the cache). Returns (out, {"cache": entry})."""
    m = cfg.mla
    h = cfg.num_heads
    b = x.shape[0]
    clen = int(cache_len)
    pos = torch.full((b, 1), clen, dtype=torch.int32, device=x.device)
    qn, qr = _project_q(params, cfg, x, pos)          # [b,1,h,dn], [b,1,h,dr]
    ckv_t, kr_t = _latent(params, cfg, x, pos)        # [b,1,kvr], [b,1,dr]
    cache["ckv"][:, clen:clen + 1].copy_(ckv_t)
    cache["kr"][:, clen:clen + 1].copy_(kr_t)
    ckv_cache = cache["ckv"].float()
    kr_cache = cache["kr"].float()

    # Absorb W_uk into the query: q_lat [b, h, kvr]
    wuk = params.w_uk.w.reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bhd,khd->bhk", qn[:, 0].float(), wuk.float())
    s_len = ckv_cache.shape[1]
    scores = (torch.einsum("bhk,bsk->bhs", q_lat, ckv_cache)
              + torch.einsum("bhr,bsr->bhs", qr[:, 0].float(), kr_cache)
              ) / float(np.sqrt(np.float32(m.nope_head_dim + m.rope_head_dim)))
    mask = torch.arange(s_len, device=x.device)[None, None, :] <= clen
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", w, ckv_cache)                 # [b,h,kvr]
    wuv = params.w_uv.w.reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhk,khd->bhd", ctx, wuv.float())
    out = o.reshape(b, h * m.v_head_dim).to(x.dtype)[:, None, :]
    return params.wo(out), {"cache": cache}
