"""LR schedules: the counterpart of the reference package's
``optim/schedule.py``. WSD (warmup-stable-decay) is MiniCPM's schedule and
the default of the training driver; cosine for comparison.

A schedule maps a step (an int or an integer tensor, the optimizer's
``count``) to a float32 0-d tensor on the step's device, by the reference's
float32 arithmetic, so it runs on the card without a host round trip.
"""
from __future__ import annotations

import math

import torch


def _step(step):
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1):
    """Warmup (linear) -> stable (constant peak) -> decay (exponential to
    final_frac * peak). Step counts are in optimizer steps."""

    def lr(step):
        step = _step(step)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        in_decay = torch.clamp((step - warmup - stable) / max(decay, 1),
                               0.0, 1.0)
        decay_mult = torch.pow(
            torch.tensor(final_frac, dtype=torch.float32, device=step.device),
            in_decay)
        return torch.where(step < warmup, warm, peak_lr * decay_mult)

    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return lr
