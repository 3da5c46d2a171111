"""Language model: embedding -> blocks -> norm -> head.

The counterpart of the reference package's ``models/lm.py``, for every
family of the registry: dense, MoE, VLM, SSM, hybrid and the
encoder-decoder (block kinds ``"attn"``, ``"moe"``, ``"mamba"`` and
``"shared_attn"``; RoPE, M-RoPE, sinusoidal or no positions; GQA attention
or MLA). The functions keep the reference's names and signatures,
with :class:`LM` (an ``nn.Module``) in place of the parameter pytree. Layers
are grouped into the same segments; the reference scans a segment's stacked
parameters, here each layer is its own module and the cache of a segment
(K/V, MLA's latent ``ckv``/``kr``, or the SSM ``state``/``conv``) is stacked
on a leading ``[n]`` axis as in the reference. The cache is updated in
place. ``forward`` returns the reference's metrics, ``moe_aux`` and
``moe_dropped`` summed over the MoE layers (zero without any).

``forward`` is the training forward: it follows the caller's autograd
mode. With gradients enabled its attention takes the differentiable
training form and, where ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint`` in
mode ``"train"``); under ``torch.no_grad()`` it scores through the
attention kernel. ``prefill`` and ``decode_step`` always run under
``torch.no_grad()``. Each takes tokens or (a VLM's stub patch embeddings)
``embeds``. Whisper, the encoder-decoder, has its own: ``encode`` (stub
frame embeddings through the non-causal encoder; it serves both),
``forward_encdec`` (its training forward, like ``forward``),
``encdec_init_cache`` (the decoder's self-attention cache and the cross
cache of the encoder's k and v, each stacked on a leading ``[n]`` layer
axis), ``prefill_encdec`` and ``decode_step_encdec``. The parameters are
made frozen; the train state makes them trainable
(:func:`repro_torch.train.steps.init_train_state`).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..api import resolve_device
from . import blocks as B
from .attention import training_form
from .common import ModelConfig, embed_init, per_device, sinusoid_positions


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    return [(k, len(list(g))) for k, g in itertools.groupby(kinds)]


class _SharedSlot(nn.Module):
    """The place of a ``"shared_attn"`` layer in :attr:`LM.blocks`. It holds
    no parameters: the layer runs :attr:`LM.shared_attn`."""

    kind = "shared_attn"


class LM(nn.Module):
    """Embedding ``[padded_vocab, d]``, the blocks, the final norm, and the
    head: ``embed.T`` when embeddings are tied, else ``lm_head`` ``[d,
    padded_vocab]``. ``blocks[i]`` is layer i: a :class:`~.blocks.Block` of
    its kind, or at a hybrid's ``"shared_attn"`` layer a parameterless slot;
    every such layer runs ``shared_attn``, the one shared ``"attn"`` block
    (None without such layers), as the reference's ``params["shared_attn"]``,
    each application with its own cache entry. So a parameter has one name:
    ``blocks.{i}.*`` for layer i's own, ``shared_attn.*`` for the shared
    block's. An encoder-decoder (``cfg.encdec``) also has ``encoder``
    (:class:`Encoder`) and ``cross_attn[i]``, layer i's
    :class:`CrossAttention`, named as the reference's tree (None
    otherwise). With no generator the weights are left uninitialised, to be
    loaded, on ``device`` (``None`` = the CUDA card; raises without one);
    with one they are drawn on the generator's device. Every parameter is
    made frozen; ``requires_grad_(True)`` makes the model trainable."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        device = (generator.device if generator is not None
                  else resolve_device(device))
        self.cfg = cfg
        dt = cfg.torch_dtype
        shape = (cfg.padded_vocab, cfg.d_model)
        kw = dict(generator=generator, device=device)

        def table(shape):
            t = (embed_init(generator, shape, dt) if generator is not None
                 else torch.empty(shape, dtype=dt, device=device))
            return nn.Parameter(t, requires_grad=False)

        kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
        self.embed = table(shape)
        self.shared_attn = (B.Block(cfg, "attn", **kw)
                            if "shared_attn" in kinds else None)
        self.blocks = nn.ModuleList(
            _SharedSlot() if kind == "shared_attn" else B.Block(cfg, kind, **kw)
            for kind in kinds)
        self.final_norm = B.Norm(cfg, device=device)
        self.lm_head = None if cfg.tie_embeddings else table(shape[::-1])
        self.encoder = self.cross_attn = None
        if cfg.encdec is not None:
            self.encoder = Encoder(cfg, **kw)
            self.cross_attn = nn.ModuleList(
                CrossAttention(cfg, **kw) for _ in range(cfg.num_layers))


class Encoder(nn.Module):
    """Whisper's encoder: ``enc_layers`` ``"attn"`` blocks, run
    non-causally, and ``final_norm`` (the reference's
    ``params["encoder"]``)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            B.Block(cfg, "attn", generator=generator, device=device)
            for _ in range(cfg.encdec.enc_layers))
        self.final_norm = B.Norm(cfg, device=device)


class CrossAttention(nn.Module):
    """One decoder layer's cross-attention: its norm ``ln`` and an
    :class:`~.blocks.Attention` over the encoder states (an entry of the
    reference's ``params["cross_attn"]``)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.ln = B.Norm(cfg, device=device)
        self.attn = B.Attention(cfg, generator=generator, device=device)


def init(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """Random weights drawn on ``generator``'s device (the reference's
    ``init(key, cfg)``)."""
    return LM(cfg, generator=generator, device=generator.device)


def param_count(cfg: ModelConfig) -> int:
    """The parameters of ``cfg``'s model, counted from its shapes on the
    meta device (nothing is allocated): the reference's ``param_count``."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top_k routed and the shared
    experts only): the reference's ``active_param_count``."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.block_kind(i) == "moe")
    return total - n_moe * (m.num_experts - m.top_k) * 3 * cfg.d_model \
        * m.d_ff_expert


def make_positions(cfg, b, t, device=None, offset=0):
    """[b, t] positions from ``offset``, or [b, 3, t] under M-RoPE (text:
    the t, h and w ids equal)."""
    pos = torch.arange(offset, offset + t, dtype=torch.int32, device=device)
    if cfg.pos == "mrope":
        return pos.expand(b, 3, t)
    return pos.expand(b, t)


def _remat(cfg, aux) -> bool:
    """Whether a layer runs under ``torch.utils.checkpoint``: in mode
    ``"train"`` with ``cfg.remat`` and gradients enabled."""
    return aux["mode"] == "train" and cfg.remat and training_form()


def _run_layer(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` where
    ``remat`` (the forward draws no random numbers: no RNG state to
    stash)."""
    if not remat:
        return fn(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def _apply_stack(params: LM, cfg, h, aux, cache):
    """Run the blocks; layer j of segment s uses entry j of ``cache[s]`` (a
    ``"shared_attn"`` segment: the shared block, its j-th application).
    A segment's layers run checkpointed where :func:`_remat` says so; the
    shared block's applications do not, as in the reference.
    Returns (h, metrics): ``moe_aux`` and ``moe_dropped`` summed over the
    MoE layers, float32 scalars on h's device."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    metrics = {"moe_aux": zero, "moe_dropped": zero}
    remat = _remat(cfg, aux)
    layer = 0
    for si, (kind, n) in enumerate(segments(cfg)):
        for j in range(n):
            a = dict(aux)
            if cache is not None:
                a["cache"] = {name: t[j] for name, t in cache[si].items()}
            if kind == "shared_attn":
                h, extras = params.shared_attn(h, a)
            else:
                h, extras = _run_layer(remat, params.blocks[layer], h, a)
            for name, x in extras.get("metrics", {}).items():
                metrics[name] = metrics[name] + x
            layer += 1
    return h, metrics


def embed_tokens(params: LM, cfg, tokens):
    return torch.nn.functional.embedding(tokens, params.embed)


def _embed(params, cfg, tokens, embeds):
    """The token rows (or ``embeds``), plus the sinusoids of positions
    0..t-1 where ``cfg.pos`` is ``"sinusoid"``."""
    h = (embed_tokens(params, cfg, tokens) if embeds is None
         else embeds.to(cfg.torch_dtype))
    if cfg.pos == "sinusoid":
        h = h + _sinusoids(h.shape[1], cfg.d_model, h)
    return h


def _sinusoids(t, d, like):
    """[1, t, d] sinusoids of positions 0..t-1 in ``like``'s dtype."""
    return sinusoid_positions(t, d, device=like.device).to(like.dtype)[None]


@per_device
def _sinusoid_div_on(d: int, device: torch.device):
    # The reference's frequencies: numpy, rounded to float32 on the device.
    div = np.exp(-np.log(10000.0) * np.arange(0, d, 2, dtype=np.float32) / d)
    return torch.from_numpy(div.astype(np.float32)).to(device)


def _sinusoid_at(pos, d, *, device):
    """[d] float32 sinusoids of one position, as a decode step adds them:
    the angles ``float32(pos) * div`` and their sin and cos in float32 on
    ``device``. Not a row of :func:`~.common.sinusoid_positions`, which
    numpy computes: the two may differ in the last ulp."""
    ang = _sinusoid_div_on(int(d), torch.device(device)) * float(int(pos))
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(d)


def _embed_step(params, cfg, tokens, cache_len):
    """A decode step's [b, 1, d] input: the token rows, plus the sinusoids
    of position ``cache_len`` where ``cfg.pos`` is ``"sinusoid"``."""
    h = embed_tokens(params, cfg, tokens[:, None])
    if cfg.pos == "sinusoid":
        h = h + _sinusoid_at(cache_len, cfg.d_model,
                             device=h.device).to(h.dtype)
    return h


def forward(params: LM, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None):
    """Training forward -> (hidden [b, t, d], metrics). Differentiable
    with gradients enabled; under ``torch.no_grad()`` a scoring forward
    through the attention kernel."""
    h = _embed(params, cfg, tokens, embeds)
    b, t, _ = h.shape
    if positions is None:
        positions = make_positions(cfg, b, t, device=h.device)
    aux = {"mode": "train", "positions": positions, "cache": None,
           "cache_len": None}
    h, metrics = _apply_stack(params, cfg, h, aux, None)
    return params.final_norm(h), metrics


@torch.no_grad()
def logits_fn(params: LM, cfg, h):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = (h @ head).float()
    if cfg.padded_vocab != cfg.vocab_size:          # mask pad columns
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Per segment, the layers' cache entries (``B.block_cache_init``)
    stacked on a leading [n] axis: ``{"k": [n, batch, max_len, Hkv, D],
    "v": ...}`` (a ``"shared_attn"`` segment: one entry an application),
    under MLA ``{"ckv": [n, batch, max_len, kv_lora_rank], "kr": [n, batch,
    max_len, rope_head_dim]}``, and for ``"mamba"`` ``{"state": [n, batch,
    nheads, head_dim, d_state], "conv": [n, batch, d_conv - 1, conv_dim]}``
    (float32). ``device`` None = the CUDA card (raises without one)."""
    device = resolve_device(device)
    out = []
    for kind, n in segments(cfg):
        kind = "attn" if kind == "shared_attn" else kind
        layers = [B.block_cache_init(cfg, kind, batch, max_len, device)
                  for _ in range(n)]
        out.append({k: torch.stack([c[k] for c in layers]) for k in layers[0]})
    return out


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, *, tokens=None, embeds=None, cache,
            return_metrics: bool = False):
    """Fill the cache with a full prompt; returns (last-token logits, cache),
    and the prompt's MoE metrics after them with ``return_metrics``."""
    h = _embed(params, cfg, tokens, embeds)
    b, t, _ = h.shape
    aux = {"mode": "prefill", "positions": make_positions(cfg, b, t,
                                                          device=h.device),
           "cache_len": t}
    h, metrics = _apply_stack(params, cfg, h, aux, cache)
    logits = logits_fn(params, cfg, params.final_norm(h)[:, -1])
    return (logits, cache, metrics) if return_metrics else (logits, cache)


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, tokens, cache, cache_len):
    """One decode step. tokens: [b] int; cache_len: int (tokens already in
    the cache). Returns (logits [b, V], cache)."""
    cache_len = int(cache_len)
    h = _embed_step(params, cfg, tokens, cache_len)
    b = h.shape[0]
    pos = make_positions(cfg, b, 1, device=h.device, offset=cache_len)
    aux = {"mode": "decode", "positions": pos, "cache_len": cache_len}
    h, _ = _apply_stack(params, cfg, h, aux, cache)
    return logits_fn(params, cfg, params.final_norm(h)[:, -1]), cache


# --------------------------------------------------------------------------
# Whisper-style encoder-decoder
# --------------------------------------------------------------------------

def encode(params: LM, cfg: ModelConfig, frames):
    """frames: [b, t_enc, d_model] stub frame embeddings -> the encoder
    states [b, t_enc, d_model]: the sinusoids added, each block with
    non-causal self-attention in mode ``"train"``, then the encoder's final
    norm. Under the serve steps (``torch.no_grad()``) the attention is the
    kernel; under :func:`forward_encdec` with gradients enabled it is the
    training form, each layer checkpointed where ``cfg.remat`` (the
    reference checkpoints the encoder's layers whenever ``cfg.remat``)."""
    h = frames.to(cfg.torch_dtype)
    h = h + _sinusoids(h.shape[1], cfg.d_model, h)
    aux = {"mode": "train", "positions": None, "cache": None,
           "cache_len": None}
    remat = _remat(cfg, aux)
    for blk in params.encoder.blocks:
        h, _ = _run_layer(remat, blk, h, aux, causal=False)
    return params.encoder.final_norm(h)


def _layer(cache, i):
    return None if cache is None else {n: t[i] for n, t in cache.items()}


def _decoder_layer(params: LM, i, h, aux, enc_out, cache, xcache):
    """Decoder layer i: causal self-attention, cross-attention
    (``cross_attn[i]``: its norm, then attention over ``enc_out``, or in
    decode over the layer's cross cache), then the MLP."""
    blk = params.blocks[i]
    a = dict(aux)
    a["cache"] = _layer(cache, i)
    y, _ = blk.attn(blk.ln1(h), a)
    h = h + y
    xa = params.cross_attn[i]
    x = xa.ln(h)
    if aux["mode"] == "decode":
        y = xa.attn.attend_cached(x, _layer(xcache, i))
    else:
        y, _ = xa.attn(x, {"mode": aux["mode"], "cache": _layer(xcache, i)},
                       kv_override=enc_out)
    h = h + y
    return h + blk.ffn(blk.ln2(h))


def _decoder_stack(params: LM, cfg, h, aux, enc_out, cache, xcache):
    """The decoder's layers (:func:`_decoder_layer`), each checkpointed
    where :func:`_remat` says so. In prefill the encoder's k and v are
    projected once and written into ``xcache`` in place."""
    if segments(cfg) != [("attn", cfg.num_layers)]:
        raise ValueError("the whisper decoder is dense")
    remat = _remat(cfg, aux)
    for i in range(cfg.num_layers):
        h = _run_layer(remat, _decoder_layer, params, i, h, aux, enc_out,
                       cache, xcache)
    return h


def forward_encdec(params: LM, cfg: ModelConfig, frames, dec_tokens):
    """Training forward of whisper -> (decoder hidden [b, t, d], {}):
    differentiable with gradients enabled, a scoring forward through the
    attention kernel under ``torch.no_grad()``."""
    enc_out = encode(params, cfg, frames)
    h = _embed(params, cfg, dec_tokens, None)
    b, t = dec_tokens.shape
    aux = {"mode": "train", "positions": make_positions(cfg, b, t,
                                                        device=h.device),
           "cache": None, "cache_len": None}
    h = _decoder_stack(params, cfg, h, aux, enc_out, None, None)
    return params.final_norm(h), {}


def encdec_init_cache(cfg: ModelConfig, batch: int, max_dec_len: int,
                      enc_len: int, device=None):
    """``{"self": {"k", "v"}, "cross": {"k", "v"}}``: the decoder's
    self-attention cache ``[n, batch, max_dec_len, Hkv, D]`` and the cross
    cache of the encoder's k and v ``[n, batch, enc_len, Hkv, D]``, zeros
    in ``cfg``'s dtype. ``device`` None = the CUDA card (raises without
    one)."""
    device = resolve_device(device)
    n = cfg.num_layers

    def stacked(length):
        shape = (n, batch, length, cfg.num_kv_heads, cfg.hd)
        return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                for name in ("k", "v")}

    return {"self": stacked(max_dec_len), "cross": stacked(enc_len)}


@torch.no_grad()
def prefill_encdec(params: LM, cfg: ModelConfig, frames, dec_tokens, cache,
                   return_metrics: bool = False):
    """Encode ``frames``, fill the cross cache with the encoder's k and v
    and the self-attention cache with the decoder prompt ``dec_tokens``;
    returns (last-token logits, cache), and zero MoE metrics after them
    with ``return_metrics`` (as :func:`prefill` returns them)."""
    enc_out = encode(params, cfg, frames)
    h = _embed(params, cfg, dec_tokens, None)
    b, t = dec_tokens.shape
    aux = {"mode": "prefill", "positions": make_positions(cfg, b, t,
                                                          device=h.device),
           "cache_len": t}
    h = _decoder_stack(params, cfg, h, aux, enc_out, cache["self"],
                       cache["cross"])
    logits = logits_fn(params, cfg, params.final_norm(h)[:, -1])
    if return_metrics:
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, cache, {"moe_aux": zero, "moe_dropped": zero}
    return logits, cache


@torch.no_grad()
def decode_step_encdec(params: LM, cfg: ModelConfig, tokens, cache,
                       cache_len):
    """One whisper decode step: tokens [b] int, cache_len int. Cross-
    attention reads the whole cross cache. Returns (logits [b, V], cache)."""
    cache_len = int(cache_len)
    h = _embed_step(params, cfg, tokens, cache_len)
    b = h.shape[0]
    aux = {"mode": "decode",
           "positions": make_positions(cfg, b, 1, device=h.device,
                                       offset=cache_len),
           "cache_len": cache_len}
    h = _decoder_stack(params, cfg, h, aux, None, cache["self"],
                       cache["cross"])
    return logits_fn(params, cfg, params.final_norm(h)[:, -1]), cache
