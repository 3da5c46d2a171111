"""Serve step builders: the counterpart of the reference package's
``train/steps.py`` ``make_prefill_step`` and ``make_decode_step``.

Prefill fills the KV cache from a prompt; a decode step advances one token,
greedily. Sampled decoding (the reference's ``jax.random.categorical``
draw) is not ported yet (ROADMAP queue 1, item 12h). The training step
belongs to a later slice (ROADMAP queue 1 item 12g).
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    lm.check_supported(cfg)

    def prefill_step(params, batch, cache, *, return_metrics=False):
        if "embeds" in batch:
            return lm.prefill(params, cfg, embeds=batch["embeds"], cache=cache,
                              return_metrics=return_metrics)
        return lm.prefill(params, cfg, tokens=batch["tokens"], cache=cache,
                          return_metrics=return_metrics)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, greedy: bool = True,
                     temperature: float = 1.0):
    lm.check_supported(cfg)
    if not greedy:
        raise NotImplementedError(
            "sampled decoding is not ported yet (ROADMAP queue 1, item 12h); "
            "use greedy=True")
    del temperature

    def decode_step(params, tokens, cache, cache_len, key=None):
        logits, cache = lm.decode_step(params, cfg, tokens, cache, cache_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return decode_step
