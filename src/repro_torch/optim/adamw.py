"""AdamW with float32 master weights, decoupled weight decay and
global-norm gradient clipping: the counterpart of the reference package's
``optim/adamw.py``, with its arithmetic.

The state mirrors the parameters by name (``named_parameters`` of an
``nn.Module``, or the keys of a dict of tensors): ``{"m": {name: f32},
"v": {name: f32}, "master": {name: f32} (with master weights), "count":
int32 0-d}``. :meth:`AdamW.update` works in place: the moments, the
master weights, ``count`` and the parameters are overwritten, a whole list
at a time (``torch._foreach_*``). It is not ``torch.optim.AdamW``, whose
clipping, master weights and bias correction differ.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

OptState = dict  # {"m": {name: f32}, "v": ..., "master": ... | absent, "count"}


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum of g^2 + 1e-16)`` over the tensors ``grads`` in float32,
    summed leaf by leaf in their order (the clip's norm)."""
    total = None
    for g in grads:
        g = g.float()
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=g.device)
        total = total + torch.sum(g * g)
    return torch.sqrt(total + 1e-16)


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements (one storage, one
    offset; fake tensors too, which have no data pointer)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def named_tensors(params) -> dict:
    """An ``nn.Module``'s parameters by name, or a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[Any], Any] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_weights: bool = True

    def _lr(self, count):
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32, device=count.device)

    def init(self, params) -> OptState:
        named = named_tensors(params)
        dev = next(iter(named.values())).device

        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for n, p in named.items()}

        state = {"m": zeros(), "v": zeros(),
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.master_weights:
            state["master"] = {n: p.detach().to(torch.float32, copy=True)
                               for n, p in named.items()}
        return state

    @torch.no_grad()
    def update(self, grads, state: OptState, params, *, grad_norm=None):
        """grads: ``{name: tensor}`` (any float dtype). Returns (params,
        state, metrics), the first two the objects passed in, updated in
        place; metrics ``grad_norm`` (before clipping) and ``lr``, float32
        0-d tensors.

        As in the reference: ``count`` advances first; ``gnorm = sqrt(sum
        of g^2 + 1e-16)`` over all leaves in float32 and the gradients
        scaled by ``min(1, clip_norm / gnorm)``; ``m = b1 m + (1 - b1) g``,
        ``v = b2 v + (1 - b2) g^2``; the update ``m / (1 - b1^count)`` over
        ``sqrt(v / (1 - b2^count)) + eps``; the new master weight ``p (1 -
        lr wd) - lr update`` with ``lr = lr(count)``, from the master
        weights or (without them) the parameters in float32; each parameter
        then takes its new value in its own dtype. ``grad_norm``, where
        given, is the norm to clip by in place of the norm of ``grads``: a
        sharded step passes each rank's shards of the gradients and the
        norm of the whole (:func:`global_norm`)."""
        named = named_tensors(params)
        names = list(named)
        count = state["count"] + 1
        gf = [grads[n].float() for n in names]
        gnorm = global_norm(gf) if grad_norm is None else grad_norm
        scale = torch.clamp(self.clip_norm / gnorm, max=1.0)
        gf = torch._foreach_mul(gf, scale)

        b1, b2 = self.b1, self.b2
        m = [state["m"][n] for n in names]
        v = [state["v"][n] for n in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gf, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(gf, 1 - b2), gf))
        del gf
        c = count.to(torch.float32)
        mhat_s = 1.0 / (1 - b1 ** c)
        vhat_s = 1.0 / (1 - b2 ** c)
        lr = self._lr(count)

        upd = torch._foreach_mul(m, mhat_s)
        den = torch._foreach_mul(v, vhat_s)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        if self.master_weights:
            base = [state["master"][n] for n in names]
        else:
            base = [named[n].detach().float() for n in names]
        torch._foreach_mul_(base, 1 - lr * self.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(base, upd)
        for n, new in zip(names, base):
            if not same_memory(new, named[n]):
                named[n].copy_(new)
        state["count"] = count
        return params, state, {"grad_norm": gnorm, "lr": lr}
