"""Language model: embedding -> blocks -> norm -> head.

The counterpart of the reference package's ``models/lm.py``, for the dense,
MoE, VLM, SSM and hybrid families (block kinds ``"attn"``, ``"moe"``,
``"mamba"`` and ``"shared_attn"``; RoPE, M-RoPE or no positions; GQA
attention or MLA). The functions keep the reference's names and signatures,
with :class:`LM` (an ``nn.Module``) in place of the parameter pytree. Layers
are grouped into the same segments; the reference scans a segment's stacked
parameters, here each layer is its own module and the cache of a segment
(K/V, MLA's latent ``ckv``/``kr``, or the SSM ``state``/``conv``) is stacked
on a leading ``[n]`` axis as in the reference. The cache is updated in
place. ``forward`` returns the reference's metrics, ``moe_aux`` and
``moe_dropped`` summed over the MoE layers (zero without any).

This slice serves: ``forward`` (a scoring forward), ``prefill`` and
``decode_step`` run under ``torch.no_grad()``, from tokens or (a VLM's stub
patch embeddings) from ``embeds``. The encoder-decoder family raises
``NotImplementedError`` naming the ROADMAP item where it waits.
"""
from __future__ import annotations

import itertools

import torch
from torch import nn

from ..api import resolve_device
from . import blocks as B
from .common import ModelConfig, embed_init

#: ROADMAP queue 1 item of each family or feature that is not ported yet.
_WAITING = (
    (lambda c: c.encdec is not None, "the encoder-decoder stack", "12f"),
    (lambda c: c.pos == "sinusoid", "sinusoidal positions", "12f"),
)


def check_supported(cfg: ModelConfig) -> None:
    for test, what, item in _WAITING:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name} needs {what}, which is not ported yet (ROADMAP "
                f"queue 1 item {item}); the port's LM runs the dense, MoE, "
                f"VLM, SSM and hybrid families")


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
    block's. With no generator the weights are left uninitialised, to be
    loaded, on ``device`` (``None`` = the CUDA card; raises without one);
    with one they are drawn on the generator's device."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
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


def init(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """Random weights drawn on ``generator``'s device (the reference's
    ``init(key, cfg)``)."""
    return LM(cfg, generator=generator, device=generator.device)


def make_positions(cfg, b, t, device=None, offset=0):
    """[b, t] positions from ``offset``, or [b, 3, t] under M-RoPE (text:
    the t, h and w ids equal)."""
    pos = torch.arange(offset, offset + t, dtype=torch.int32, device=device)
    if cfg.pos == "mrope":
        return pos.expand(b, 3, t)
    return pos.expand(b, t)


def _apply_stack(params: LM, cfg, h, aux, cache):
    """Run the blocks; layer j of segment s uses entry j of ``cache[s]`` (a
    ``"shared_attn"`` segment: the shared block, its j-th application).
    Returns (h, metrics): ``moe_aux`` and ``moe_dropped`` summed over the
    MoE layers, float32 scalars on h's device."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    metrics = {"moe_aux": zero, "moe_dropped": zero}
    layer = 0
    for si, (kind, n) in enumerate(segments(cfg)):
        for j in range(n):
            a = dict(aux)
            if cache is not None:
                a["cache"] = {name: t[j] for name, t in cache[si].items()}
            block = (params.shared_attn if kind == "shared_attn"
                     else params.blocks[layer])
            h, extras = block(h, a)
            for name, x in extras.get("metrics", {}).items():
                metrics[name] = metrics[name] + x
            layer += 1
    return h, metrics


def embed_tokens(params: LM, cfg, tokens):
    return params.embed[tokens]


def _embed(params, cfg, tokens, embeds):
    return (embed_tokens(params, cfg, tokens) if embeds is None
            else embeds.to(cfg.torch_dtype))


@torch.no_grad()
def forward(params: LM, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None):
    """Scoring forward -> (hidden [b, t, d], metrics)."""
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
    check_supported(cfg)
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
    h = embed_tokens(params, cfg, tokens[:, None])
    b = h.shape[0]
    pos = make_positions(cfg, b, 1, device=h.device, offset=cache_len)
    aux = {"mode": "decode", "positions": pos, "cache_len": cache_len}
    h, _ = _apply_stack(params, cfg, h, aux, cache)
    return logits_fn(params, cfg, params.final_norm(h)[:, -1]), cache
