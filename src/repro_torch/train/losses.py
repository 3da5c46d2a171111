"""Chunked cross-entropy: the [B, T, vocab] logits tensor never materializes.

The counterpart of the reference package's ``train/losses.py``. The head
matmul and the log-softmax run per sequence chunk in float32, each chunk
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` in a
``lax.scan``), so the live logits are one chunk's and the backward
recomputes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

NEG = -1e30                 # the reference's value for masked vocab columns


def _chunk_sums(hc, head, lc, mc, z_loss: float, valid_vocab):
    """One chunk: (nll sum, z-loss sum, mask sum, correct sum), float32."""
    logits = hc.float() @ head.float()                            # [b, c, V]
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_vocab, logits, NEG)
    lse = torch.logsumexp(logits, dim=-1)                         # [b, c]
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    nll = (lse - gold) * mc
    zl = (lse ** 2) * mc * z_loss
    correct = (logits.argmax(-1) == lc).float() * mc
    return nll.sum(), zl.sum(), mc.sum(), correct.sum()


def chunked_xent_sums(h, head, labels, mask=None, chunk: int = 2048,
                      z_loss: float = 0.0, valid_vocab: int | None = None):
    """The sums :func:`chunked_softmax_xent` divides, float32 0-d tensors:
    (masked nll sum, ``z_loss`` times the masked ``logsumexp ** 2`` sum,
    mask sum, masked correct count); the first two carry gradients. A
    sharded step reduces them over the data ranks before dividing."""
    b, t, _ = h.shape
    c = min(chunk, t)
    pad = -t % c
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.float32, device=h.device)
    mask = mask.float()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    loss_sum = z_sum = denom = ncorrect = zero
    for s in range(0, t + pad, c):
        sums = torch.utils.checkpoint.checkpoint(
            _chunk_sums, h[:, s:s + c], head, labels[:, s:s + c],
            mask[:, s:s + c], z_loss, valid_vocab, use_reentrant=False,
            preserve_rng_state=False)
        loss_sum, z_sum = loss_sum + sums[0], z_sum + sums[1]
        denom, ncorrect = denom + sums[2], ncorrect + sums[3]
    return loss_sum, z_sum, denom, ncorrect


def xent_from_sums(loss_sum, z_sum, denom, ncorrect):
    """(mean loss, metrics) from the sums of :func:`chunked_xent_sums`."""
    denom = torch.clamp(denom, min=1.0)
    loss = loss_sum / denom + z_sum / denom
    return loss, {"xent": loss_sum / denom, "accuracy": ncorrect / denom,
                  "tokens": denom}


def chunked_softmax_xent(h, head, labels, mask=None, chunk: int = 2048,
                         z_loss: float = 0.0, valid_vocab: int | None = None):
    """h: [b, t, d]; head: [d, V]; labels: [b, t] ints; mask: [b, t]
    (1 = count).

    ``valid_vocab``: mask logit columns >= this (padded embedding tables).
    Returns (mean_loss, metrics), the loss float32: the masked mean of the
    negative log-likelihood plus ``z_loss`` times the masked mean of
    ``logsumexp ** 2``; metrics ``xent``, ``accuracy`` and ``tokens`` (the
    mask's sum, at least 1).
    """
    return xent_from_sums(*chunked_xent_sums(h, head, labels, mask, chunk,
                                             z_loss, valid_vocab))
