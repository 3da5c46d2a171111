"""Transformer block assembly, as ``nn.Module``s.

The counterpart of the reference package's ``models/blocks.py`` for block
kinds ``"attn"`` (norm, attention, norm, dense MLP), ``"moe"`` (the MoE
FFN of :mod:`.moe` in place of the MLP) and ``"mamba"`` (norm and a Mamba2
mixer of :mod:`.ssm`, no FFN), with GQA attention (RoPE or M-RoPE) and a KV
cache, or MLA (:mod:`.mla`, a latent cache) in every attention layer when
``cfg.mla`` is set. The hybrid's ``"shared_attn"`` layers run one shared
``"attn"`` block (:class:`repro_torch.models.lm.LM`); whisper's encoder
runs ``"attn"`` blocks non-causally and its decoder adds a
cross-attention :class:`Attention` a layer (``kv_override``).
Every weight keeps the reference's ``[in, out]`` orientation
(``y = x @ w``) and its parameter path (``attn.wq.w``, ``ffn.w_down.b``), so
a reference parameter tree maps onto a block leaf for leaf
(:func:`repro_torch.convert.lm_params_from_numpy`).

A block's forward takes ``aux = {mode: train|prefill|decode, positions,
cache (the layer's entry or None), cache_len}`` and returns ``(h, extras)``
with ``extras = {cache: entry}`` in prefill and decode, as the reference's
``block_apply`` does, and ``extras["metrics"]`` (``moe_aux``,
``moe_dropped``) from a ``"moe"`` block. The reference returns a new cache;
here the entry's tensors are updated in place (an index copy) and returned.
Mode ``"train"`` is differentiable: with gradients enabled its attention
takes the training form (:func:`.attention.training_form`), under
``torch.no_grad()`` the kernel. Prefill and decode run under
``torch.no_grad()`` (the :mod:`.lm` serve functions), so no cache write
enters a graph.

Parameters are made frozen (``requires_grad`` False): a model loaded for
serving or scoring needs no autograd, and the weights are filled in place
after they are made. Training makes them trainable
(``module.requires_grad_(True)``; :func:`repro_torch.train.steps.init_train_state`).
"""
from __future__ import annotations

import torch
from torch import nn

from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import blockwise_attention, training_form
from .common import (ModelConfig, act_fn, apply_mrope, apply_rope, dense_init,
                     layernorm, rmsnorm)


def _param(shape, dtype, device, generator=None, fill=None):
    """A frozen parameter drawn by ``dense_init`` on ``generator``, filled
    with ``fill``, or left uninitialised (to be loaded) when both are
    None."""
    if generator is not None and fill is None:
        t = dense_init(generator, shape, dtype)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
        if fill is not None:
            t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``x @ w (+ b)`` with w ``[in, out]``; the bias starts at zero."""

    def __init__(self, d_in, d_out, cfg: ModelConfig, *, bias=False,
                 generator=None, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.w = _param((d_in, d_out), dt, device, generator)
        self.b = _param((d_out,), dt, device, fill=0.0) if bias else None

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


class Norm(nn.Module):
    """rmsnorm, or layernorm with a bias (``cfg.norm``)."""

    def __init__(self, cfg: ModelConfig, d=None, *, device=None):
        super().__init__()
        d = d or cfg.d_model
        self.cfg = cfg
        self.w = _param((d,), cfg.torch_dtype, device, fill=1.0)
        self.b = (_param((d,), cfg.torch_dtype, device, fill=0.0)
                  if cfg.norm == "layernorm" else None)

    def forward(self, x):
        if self.cfg.norm == "layernorm":
            return layernorm(x, self.w, self.b, self.cfg.norm_eps)
        return rmsnorm(x, self.w, self.cfg.norm_eps)


class MLP(nn.Module):
    """Gated (``w_gate``, ``w_up``, ``w_down``) or plain two-matrix MLP,
    the plain one with biases under ``proj_bias``. ``d_ff`` and ``glu``
    default to ``cfg``'s (the MoE's shared experts: their own width, always
    gated)."""

    def __init__(self, cfg: ModelConfig, *, d_ff=None, glu=None,
                 generator=None, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.glu = cfg.mlp_glu if glu is None else glu
        self.act = act_fn(cfg.act)
        if self.glu:
            self.w_gate = Dense(d, f, cfg, **kw)
            self.w_up = Dense(d, f, cfg, **kw)
            self.w_down = Dense(f, d, cfg, **kw)
        else:
            self.w_up = Dense(d, f, cfg, bias=cfg.proj_bias, **kw)
            self.w_down = Dense(f, d, cfg, bias=cfg.proj_bias, **kw)

    def forward(self, x):
        if self.glu:
            return self.w_down(self.act(self.w_gate(x)) * self.w_up(x))
        return self.w_down(self.act(self.w_up(x)))


class Attention(nn.Module):
    """GQA/MQA/MHA attention with a KV cache (``attn_apply``): self-attention,
    causal or not, or cross-attention over ``kv_override`` (whisper's
    decoder over the encoder states)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.wq = Dense(d, h * hd, cfg, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(d, hkv * hd, cfg, bias=cfg.qkv_bias, **kw)
        self.wv = Dense(d, hkv * hd, cfg, bias=cfg.qkv_bias, **kw)
        self.wo = Dense(h * hd, d, cfg, bias=cfg.proj_bias, **kw)

    def _chunk(self):
        return dict(q_chunk=self.cfg.attn_chunk, kv_chunk=self.cfg.attn_chunk)

    def _out(self, out):
        b, t = out.shape[:2]
        return self.wo(out.reshape(b, t, -1))

    def forward(self, x, aux, *, causal=True, kv_override=None):
        """train (no cache; the training form with gradients enabled),
        prefill (writes the cache from position 0) or decode (writes
        position ``cache_len``, then attends with ``kv_len = cache_len +
        1``), each causal or not. With ``kv_override`` [b, s, d]:
        cross-attention, k and v projected from it, non-causal over all of
        it, whatever the mode (in ``"train"`` with gradients enabled, the
        training form); where
        ``aux["cache"]`` is given the projected k and v are written into it
        in place (whisper's cross cache, filled in prefill). Returns (out,
        extras)."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        q = self.wq(x).reshape(b, t, h, hd)
        extras = {}
        if kv_override is not None:
            s = kv_override.shape[1]
            k = self.wk(kv_override).reshape(b, s, hkv, hd)
            v = self.wv(kv_override).reshape(b, s, hkv, hd)
            cache = aux.get("cache")
            if cache is not None:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
                extras["cache"] = cache
            out = blockwise_attention(
                q, k, v, causal=False, **self._chunk(),
                differentiable=aux["mode"] == "train" and training_form())
            return self._out(out), extras
        k = self.wk(x).reshape(b, t, hkv, hd)
        v = self.wv(x).reshape(b, t, hkv, hd)
        if cfg.pos in ("rope", "mrope"):
            # positions [b, t], or [b, 3, t] under M-RoPE.
            rot = apply_rope if cfg.pos == "rope" else apply_mrope
            pos = aux["positions"]
            q = rot(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
            k = rot(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        mode = aux["mode"]
        if mode == "train":
            # The training form with gradients enabled, else the kernel.
            out = blockwise_attention(q, k, v, causal=causal, **self._chunk(),
                                      differentiable=training_form())
        elif mode == "prefill":
            cache = aux["cache"]
            cache["k"][:, :t].copy_(k)
            cache["v"][:, :t].copy_(v)
            out = blockwise_attention(q, k, v, causal=causal, **self._chunk())
            extras["cache"] = cache
        elif mode == "decode":
            cache, clen = aux["cache"], int(aux["cache_len"])
            cache["k"][:, clen:clen + t].copy_(k)
            cache["v"][:, clen:clen + t].copy_(v)
            out = blockwise_attention(q, cache["k"], cache["v"], causal=causal,
                                      kv_len=clen + 1, **self._chunk())
            extras["cache"] = cache
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return self._out(out), extras

    def attend_cached(self, x, cache):
        """Cross-attention of a decode step: q projected from x, then
        non-causal over the whole of ``cache``'s k and v (no ``kv_len``),
        and ``wo`` with its bias, as the reference's decoder projects by
        hand."""
        cfg = self.cfg
        b, t, _ = x.shape
        q = self.wq(x).reshape(b, t, cfg.num_heads, cfg.hd)
        out = blockwise_attention(q, cache["k"], cache["v"], causal=False,
                                  **self._chunk())
        return self._out(out)


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "moe", "mamba"):
        raise ValueError(f"unknown block kind {kind!r}")


class Block(nn.Module):
    """Pre-norm block. Kinds ``"attn"`` and ``"moe"``: attention (MLA when
    ``cfg.mla`` is set, in every layer), then the dense MLP (``"attn"``) or
    the MoE FFN (``"moe"``). Kind ``"mamba"``: ``ln1`` and the Mamba2 mixer
    (``mamba``), ``h + mamba(ln1(h))``, with no FFN."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", *,
                 generator=None, device=None):
        super().__init__()
        _check_kind(kind)
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.ln1 = Norm(cfg, device=device)
        if kind == "mamba":
            self.mamba = ssm_mod.Mamba2(cfg, **kw)
            return
        self.attn = (mla_mod.MLA(cfg, **kw) if cfg.mla is not None
                     else Attention(cfg, **kw))
        self.ln2 = Norm(cfg, device=device)
        self.ffn = moe_mod.MoE(cfg, **kw) if kind == "moe" else MLP(cfg, **kw)

    def forward(self, h, aux, *, causal=True):
        """``causal=False`` runs the attention non-causally (whisper's
        encoder; GQA attention only)."""
        if self.kind == "mamba":
            y, extras = self.mamba(self.ln1(h), aux)
            return h + y, extras
        x = self.ln1(h)
        y, extras = (self.attn(x, aux) if causal
                     else self.attn(x, aux, causal=False))
        h = h + y
        x = self.ln2(h)
        if self.kind == "moe":
            y, extras["metrics"] = self.ffn(x)
        else:
            y = self.ffn(x)
        return h + y, extras


def ssm_prefill_cache(mamba: "ssm_mod.Mamba2", cfg: ModelConfig, x):
    """The SSM cache entry after the sequence x (the ln1 output): the scan's
    final state, in float32, and the last ``d_conv - 1`` conv inputs."""
    return ssm_mod.apply_seq(mamba, cfg, x, return_cache=True)[1]


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device):
    """The layer's cache entry: the SSM state and conv tail for kind
    ``"mamba"``, else MLA's latent cache when ``cfg.mla`` is set, else the
    K/V cache."""
    _check_kind(kind)
    if kind == "mamba":
        return ssm_mod.init_cache(cfg, batch, device)
    if cfg.mla is not None:
        return mla_mod.init_cache(cfg, batch, max_len, device)
    return attn_cache_init(cfg, batch, max_len, device)
