"""Mamba2 (state-space duality, SSD) blocks, as an ``nn.Module``.

The counterpart of the reference package's ``models/ssm.py``, under its
function names. The sequence form is the chunked SSD algorithm: within a
chunk a quadratic, attention-like term; between chunks a recurrence over
the chunk states (a loop over chunks here, a ``lax.scan`` there). Decode
keeps an O(1) state per token: the SSM state ``[b, h, p, n]`` and the last
``d_conv - 1`` inputs of the causal conv, both float32. There is no kernel
here: the reference computes the scan with jnp outside any Pallas kernel,
and the port with torch ops.

As in the reference: ngroups = 1, ``A_log``, ``D`` and ``dt_bias`` are
float32 whatever the model's dtype, softplus is ``logaddexp(x, 0)`` (as
``jax.nn.softplus``), the conv is a sum of ``d_conv`` shifted products in
the input's dtype, and the output is gated through an rmsnorm.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import blocks as B
from .common import ModelConfig, dense_init, rmsnorm


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state  # x, B, C go through the conv
    return d_inner, nheads, conv_dim


class _Conv(nn.Module):
    """``w`` [d_conv, conv_dim] (normal x 0.5) and ``b`` (zeros)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        s, conv_dim = cfg.ssm, dims(cfg)[2]
        dt = cfg.torch_dtype
        self.w = (nn.Parameter(dense_init(generator, (s.d_conv, conv_dim), dt,
                                          scale=0.5), requires_grad=False)
                  if generator is not None
                  else B._param((s.d_conv, conv_dim), dt, device))
        self.b = B._param((conv_dim,), dt, device, fill=0.0)


class _GateNorm(nn.Module):
    """``w`` [d_inner] (ones): the gated output's rmsnorm."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.w = B._param((dims(cfg)[0],), cfg.torch_dtype, device, fill=1.0)


class Mamba2(nn.Module):
    """``in_proj.w`` [d, 2 d_inner + 2 d_state + nheads] (z, x, B, C, dt),
    ``conv``, ``A_log``, ``D`` and ``dt_bias`` [nheads] (float32),
    ``norm.w`` [d_inner] and ``out_proj.w`` [d_inner, d]: the reference's
    parameter paths. Random weights follow the reference's recipe on the
    torch generator: ``A_log = log(1..nheads)``, ``D = 1``, ``dt_bias`` the
    inverse softplus of ``exp(U(log 1e-3, log 1e-1))``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        s = cfg.ssm
        d_inner, nheads, _ = dims(cfg)
        kw = dict(generator=generator, device=device)
        f32 = torch.float32
        self.cfg = cfg
        self.in_proj = B.Dense(cfg.d_model,
                               2 * d_inner + 2 * s.d_state + nheads, cfg, **kw)
        self.conv = _Conv(cfg, **kw)
        self.A_log = B._param((nheads,), f32, device)
        self.D = B._param((nheads,), f32, device, fill=1.0)
        self.dt_bias = B._param((nheads,), f32, device)
        self.norm = _GateNorm(cfg, device=device)
        self.out_proj = B.Dense(d_inner, cfg.d_model, cfg, **kw)
        if generator is not None:
            dev = generator.device
            self.A_log.copy_(torch.log(torch.arange(1, nheads + 1, dtype=f32,
                                                    device=dev)))
            u = torch.rand(nheads, generator=generator, dtype=f32, device=dev)
            dt = torch.exp(u * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(self, x, aux):
        """train (no cache), prefill (writes the cache entry) or decode (one
        token against the entry, updated in place). Returns (out, extras)."""
        mode = aux["mode"]
        if mode == "train":
            return apply_seq(self, self.cfg, x), {}
        if mode == "prefill":
            cache = aux["cache"]
            out, entry = apply_seq(self, self.cfg, x, return_cache=True)
            for name in ("state", "conv"):
                cache[name].copy_(entry[name])
            return out, {"cache": cache}
        if mode == "decode":
            return apply_decode(self, self.cfg, x, aux["cache"])
        raise ValueError(f"unknown mode {mode!r}")


def _split(cfg, zxbcdt):
    """z, x, B, C, dt: views of the in-projection's output."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    return zxbcdt.split([d_inner, d_inner, s.d_state, s.d_state, nheads],
                        dim=-1)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), with no linear branch above a
    # threshold as torch.nn.functional.softplus has.
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum_exp(a):
    """a: [..., q, h] per-step log decay -> L [..., h, q, q] with
    L[i, j] = exp(sum_{j<k<=i} a_k) for i >= j else 0. Above the diagonal
    the differences are positive and their exp may overflow to inf, so the
    mask goes on the argument: -inf there, whose exp is 0. (A select after
    the exp gives the same values, but its backward multiplies the masked
    inf by a zero gradient: NaN.)"""
    q = a.shape[-2]
    cs = torch.cumsum(a, dim=-2)                                  # [..., q, h]
    diff = cs[..., :, None, :] - cs[..., None, :, :]              # [..., i, j, h]
    mask = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    L = torch.exp(torch.where(mask[..., None], diff, -torch.inf))
    return L.movedim(-1, -3)                                      # [..., h, i, j]


def ssd_scan(x, dt, A, B, C, chunk: int, compute_dtype=torch.float32):
    """Chunked SSD. x: [b,t,h,p], dt: [b,t,h] (>=0), A: [h] (<0),
    B, C: [b,t,n] (ngroups=1). Returns (y [b,t,h,p] float32, final_state
    [b,h,p,n] float32).

    ``t`` is padded with zeros up to a multiple of ``chunk``; dt = 0 there,
    so the final state is that of the real positions. ``compute_dtype`` is
    the dtype the big einsums' operands are rounded to (decay-weighted x,
    the decays, B and C); as the reference's ``preferred_element_type``,
    their products and sums are f32, and so is the inter-chunk recurrence.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    pad = -t % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    tp = t + pad
    nc = tp // chunk
    cd = compute_dtype
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).to(cd)
    Cc = C.reshape(b, nc, chunk, n).to(cd)
    a = dtc * A                                                   # [b,c,q,h]

    xdt = (xc.float() * dtc[..., None]).to(cd)                    # [b,c,q,h,p]

    # --- intra-chunk (quadratic within chunk) ---
    L = _segsum_exp(a).to(cd)                                     # [b,c,h,q,q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc.float(), Bc.float()).to(cd)
    y_diag = torch.einsum("bchij,bcjhp->bcihp",
                          scores.float()[:, :, None] * L.float(), xdt.float())

    # --- chunk summary states ---
    a_cs = torch.cumsum(a, dim=2)                                 # [b,c,q,h]
    a_tail = a_cs[:, :, -1:, :] - a_cs                            # decay to chunk end
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc.float(),
                          torch.exp(a_tail).to(cd).float()[..., None]
                          * xdt.float())

    # --- inter-chunk recurrence ---
    decay = torch.exp(a_cs[:, :, -1, :])                          # [b,c,h]
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                           # [b,c,h,p,n]

    # --- inter-chunk contribution ---
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc.float(),
                         hprevs.to(cd).float())
    y_off = y_off * torch.exp(a_cs).to(cd).float()[..., None]

    y = (y_diag + y_off).reshape(b, tp, h, p)[:, :t]
    return y, hcur


def _conv1d(u, w, b, init_state=None):
    """Causal depthwise conv. u: [b, t, c], w: [k, c] -> [b, t, c], a sum
    of k shifted products in u's dtype (in the reference's order), plus the
    bias. ``init_state`` [b, k - 1, c] stands before u (cast to u's dtype);
    without it, zeros."""
    k = w.shape[0]
    if init_state is None:
        upad = F.pad(u, (0, 0, k - 1, 0))
    else:
        upad = torch.cat([init_state.to(u.dtype), u], dim=1)
    out = sum(upad[:, i:i + u.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def _gate(params: Mamba2, cfg, y, z):
    return rmsnorm(y * F.silu(z.float()).to(y.dtype), params.norm.w,
                   cfg.norm_eps)


def apply_seq(params: Mamba2, cfg: ModelConfig, h_in, *,
              return_cache: bool = False):
    """Full-sequence Mamba2 block. h_in: [b, t, d_model] -> same shape.
    With ``return_cache`` also the decode cache entry after the sequence,
    the reference's ``blocks.ssm_prefill_cache``: ``state``, the SSD scan's
    final state in float32 (whatever ``compute_dtype``: a second scan in
    float32 where that is not float32), and ``conv``, the last ``d_conv -
    1`` conv inputs in float32."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    zxbcdt = h_in @ params.in_proj.w
    z, _, _, _, dt = _split(cfg, zxbcdt)
    conv_in = zxbcdt[..., d_inner:2 * d_inner + 2 * s.d_state]    # x, B, C
    conv_out = F.silu(_conv1d(conv_in, params.conv.w, params.conv.b))
    x, Bm, Cm = conv_out.split([d_inner, s.d_state, s.d_state], dim=-1)
    bsz, t, _ = h_in.shape
    xh = x.reshape(bsz, t, nheads, s.head_dim)
    dtp = _softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    cd = getattr(torch, s.compute_dtype)
    y, final = ssd_scan(xh, dtp, A, Bm, Cm, s.chunk, compute_dtype=cd)
    y = y + params.D[None, None, :, None] * xh.float()
    y = y.reshape(bsz, t, d_inner).to(h_in.dtype)
    out = _gate(params, cfg, y, z) @ params.out_proj.w
    if not return_cache:
        return out
    if t < s.d_conv - 1:
        # The reference would keep a conv tail of t rows, not d_conv - 1,
        # and its next decode step would shift the wrong inputs.
        raise ValueError(f"an SSM prefill needs at least d_conv - 1 = "
                         f"{s.d_conv - 1} tokens, got {t}")
    if cd != torch.float32:
        _, final = ssd_scan(xh, dtp, A, Bm, Cm, s.chunk)
    return out, {"state": final,
                 "conv": conv_in[:, -(s.d_conv - 1):, :].float()}


def init_cache(cfg: ModelConfig, batch: int, device):
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    return {
        "state": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }


def apply_decode(params: Mamba2, cfg: ModelConfig, h_in, cache):
    """Single-token step. h_in: [b, 1, d_model] -> ([b, 1, d_model],
    {"cache": cache}), the cache entry's ``state`` and ``conv`` updated in
    place."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    zxbcdt = h_in @ params.in_proj.w
    z, _, _, _, dt = _split(cfg, zxbcdt)
    conv_in = zxbcdt[..., d_inner:2 * d_inner + 2 * s.d_state]    # [b, 1, c]
    conv_out = F.silu(_conv1d(conv_in, params.conv.w, params.conv.b,
                              init_state=cache["conv"]))
    new_conv = torch.cat([cache["conv"], conv_in.float()], dim=1)[:, 1:]
    x, Bm, Cm = conv_out.split([d_inner, s.d_state, s.d_state], dim=-1)
    bsz = h_in.shape[0]
    xh = x.reshape(bsz, nheads, s.head_dim).float()
    dtp = _softplus(dt[:, 0].float() + params.dt_bias)            # [b, h]
    A = -torch.exp(params.A_log)
    dA = torch.exp(dtp * A)                                       # [b, h]
    Bf = Bm[:, 0].float()                                         # [b, n]
    Cf = Cm[:, 0].float()
    dBx = (dtp[..., None] * xh)[..., None] * Bf[:, None, None, :]  # [b,h,p,n]
    state = cache["state"] * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cf, state)
    y = y + params.D[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(h_in.dtype)
    out = _gate(params, cfg, y, z) @ params.out_proj.w
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return out, {"cache": cache}
