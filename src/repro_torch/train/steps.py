"""Serve step builders: the counterpart of the reference package's
``train/steps.py`` ``make_prefill_step`` and ``make_decode_step``.

Prefill fills the KV cache from a prompt (whisper: encodes the frames and
fills the cross cache too); a decode step advances one token, greedily or
sampled as the reference samples, ``jax.random.categorical(key, logits /
temperature)`` under JAX's default (partitionable) Threefry layout: the
argmax of ``logits / temperature`` plus Gumbel noise drawn from ``key``
(:func:`repro_torch.core.prng.gumbel`). The training step belongs to a
later slice (ROADMAP queue 1 item 12g).
"""
from __future__ import annotations

import torch

from ..core import prng
from ..models import lm
from ..models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache, *, return_metrics=False):
        if cfg.encdec is not None:
            return lm.prefill_encdec(params, cfg, batch["frames"],
                                     batch["tokens"], cache,
                                     return_metrics=return_metrics)
        if "embeds" in batch:
            return lm.prefill(params, cfg, embeds=batch["embeds"], cache=cache,
                              return_metrics=return_metrics)
        return lm.prefill(params, cfg, tokens=batch["tokens"], cache=cache,
                          return_metrics=return_metrics)

    return prefill_step


def sample(key, logits, temperature: float = 1.0):
    """``jax.random.categorical(key, logits / temperature, axis=-1)`` under
    JAX's default counter layout: ``argmax(gumbel + logits / T)``, the
    Gumbel noise of shape ``logits.shape`` from ``key`` (the port's ``[2]``
    key, :func:`repro_torch.core.prng.key`), drawn on the logits' device.
    Returns int32 tokens."""
    key = torch.as_tensor(key, dtype=torch.int64).to(logits.device)
    noise = prng.gumbel(key, logits.shape)
    return torch.argmax(noise + logits / temperature, dim=-1).to(torch.int32)


def make_decode_step(cfg: ModelConfig, *, greedy: bool = True,
                     temperature: float = 1.0):
    def decode_step(params, tokens, cache, cache_len, key=None):
        if cfg.encdec is not None:
            logits, cache = lm.decode_step_encdec(params, cfg, tokens, cache,
                                                  cache_len)
        else:
            logits, cache = lm.decode_step(params, cfg, tokens, cache,
                                           cache_len)
        if greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            if key is None:
                raise ValueError("sampled decoding needs a key")
            nxt = sample(key, logits, temperature)
        return nxt, logits, cache

    return decode_step
