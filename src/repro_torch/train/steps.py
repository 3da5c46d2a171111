"""Train and serve step builders: the counterpart of the reference package's
``train/steps.py``.

``make_train_step`` returns a function (state, batch) -> (state, metrics)
that updates the train state in place: the loss (``make_loss_fn``: the
training forward, the chunked cross-entropy and the MoE load-balance term)
and its gradients by autograd, accumulated over ``grad_accum`` microbatches
in float32 where asked, then one optimizer update. The train state is
``{"params": LM (trainable), "opt": the optimizer's state, "step": int32}``
(``init_train_state``).

Prefill fills the KV cache from a prompt (whisper: encodes the frames and
fills the cross cache too); a decode step advances one token, greedily or
sampled as the reference samples, ``jax.random.categorical(key, logits /
temperature)`` under JAX's default (partitionable) Threefry layout: the
argmax of ``logits / temperature`` plus Gumbel noise drawn from ``key``
(:func:`repro_torch.core.prng.gumbel`).
"""
from __future__ import annotations

import torch

from ..core import prng
from ..models import lm
from ..models.common import ModelConfig
from ..optim.adamw import named_tensors
from .losses import chunked_softmax_xent


def forward_hidden(params, cfg: ModelConfig, batch):
    """The training forward of a batch -> (final hidden states, the
    forward's metrics, the head [d, V]). A batch holds ``frames`` and
    ``tokens`` (encoder-decoder), ``embeds`` (a VLM's stub patch
    embeddings) or ``tokens``. The head is ``embed.T`` when embeddings are
    tied, else ``lm_head``."""
    if cfg.encdec is not None:
        h, metrics = lm.forward_encdec(params, cfg, batch["frames"],
                                       batch["tokens"])
    elif "embeds" in batch:
        h, metrics = lm.forward(params, cfg, embeds=batch["embeds"])
    else:
        h, metrics = lm.forward(params, cfg, tokens=batch["tokens"])
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h, metrics, head


def microbatches(batch, grad_accum: int) -> list:
    """The batch cut into ``grad_accum`` equal microbatches along its first
    axis (rows ``[i B / ga, (i + 1) B / ga)``), as the reference cuts it."""
    sizes = {x.shape[0] for x in batch.values()}
    if len(sizes) != 1 or sizes.pop() % grad_accum:
        raise ValueError(f"the batch's first axes "
                         f"{[x.shape[0] for x in batch.values()]} do not "
                         f"split into {grad_accum} equal microbatches")
    return [{k: x.reshape(grad_accum, -1, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(grad_accum)]


def make_loss_fn(cfg: ModelConfig, moe_aux_coef: float = 0.01,
                 z_loss: float = 0.0):
    """loss_fn(params, batch) -> (total loss, metrics) of a batch
    (:func:`forward_hidden`'s, with ``labels`` and optionally ``mask``): the
    total adds ``moe_aux_coef * moe_aux`` where the forward reports MoE
    metrics (every forward but the encoder-decoder's, zero without MoE)."""
    def loss_fn(params, batch):
        h, metrics, head = forward_hidden(params, cfg, batch)
        loss, lmetrics = chunked_softmax_xent(
            h, head, batch["labels"], batch.get("mask"), chunk=cfg.loss_chunk,
            z_loss=z_loss, valid_vocab=cfg.vocab_size)
        total = loss
        if metrics:
            total = total + moe_aux_coef * metrics.get("moe_aux", 0.0)
        return total, {**lmetrics, **metrics}

    return loss_fn


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     optimizer) -> dict:
    """Random weights drawn on ``generator``'s device (:func:`lm.init`),
    made trainable, and the optimizer's fresh state."""
    params = lm.init(generator, cfg).requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def _grads(loss, leaves):
    """d loss / d leaf for each leaf (zeros where the loss does not reach
    it, as ``jax.grad`` gives)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def _detached(metrics):
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, optimizer, *, grad_accum: int = 1,
                    moe_aux_coef: float = 0.01, z_loss: float = 0.0):
    """train_step(state, batch) -> (state, metrics), the state updated in
    place. Batch tensors lie on the parameters' device, the batch axis
    first. Metrics: ``loss`` (the total), the loss's and the forward's
    metrics, the optimizer's ``grad_norm`` and ``lr``. With ``grad_accum >
    1`` the batch is cut into that many equal microbatches along its first
    axis, their gradients summed in float32 and divided by ``grad_accum``,
    and the loss averaged; the metrics are then only ``loss`` and the
    optimizer's, as in the reference."""
    loss_fn = make_loss_fn(cfg, moe_aux_coef, z_loss)

    def train_step(state, batch):
        params = state["params"]
        named = named_tensors(params)
        names, leaves = list(named), list(named.values())
        if grad_accum == 1:
            loss, metrics = loss_fn(params, batch)
            grads = _grads(loss, leaves)
            loss, metrics = loss.detach(), _detached(metrics)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in microbatches(batch, grad_accum):
                l, _ = loss_fn(params, mb)
                torch._foreach_add_(grads, [g.float() for g in
                                            _grads(l, leaves)])
                loss = loss + l.detach()
            torch._foreach_div_(grads, grad_accum)
            loss = loss / grad_accum
            metrics = {}
        _, _, om = optimizer.update(dict(zip(names, grads)), state["opt"],
                                    params)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, **metrics, **om}

    return train_step


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

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
