"""Mixture-of-Experts FFN with capacity-based grouped dispatch, as an
``nn.Module``.

The counterpart of the reference package's ``models/moe.py``. Groups are
sequences (G == batch). Each token picks its top-k experts by router weight;
each expert takes at most ``cap = min(max(1, ceil(k * t * cf / E)), t * k)``
assignments a group, the rest are dropped (counted in ``moe_dropped``).
Which assignments survive the cut is the dispatch order:

  * ``"criticality"``: per expert, by DESCENDING router weight, the
    token-to-expert form of the paper's criticality-sorted ready-node
    memory: under capacity pressure the least critical assignments drop;
  * ``"arrival"``: first come first served in token order (the in-order
    baseline).

The arithmetic follows the reference step for step, so both drop the same
assignments: the router product and softmax in float32 (the router weight
stays float32 in a bfloat16 model), a tie-stable top-k (lower expert index
first on ties, as ``jax.lax.top_k``), the criticality key ``fe * 2 + (1 -
fw)`` in float32 (``fw`` detached, as the reference's ``stop_gradient``)
under a STABLE argsort, positions by ``cumsum``, the
``[G, E, cap]`` token and weight tables (the reference's ``mode="drop"``
scatters as masked ``index_put_``), the gather to ``[G, E, cap, d]``, the
three expert products (``torch.einsum``: the reference computes them outside
any Pallas kernel too), the combine weight cast to the experts' output
dtype before the multiply, the scatter-add into ``[G, t + 1, d]`` (row t
the pad row) and the shared experts. ``MoECfg.ep_constraint`` pins a mesh
axis in the reference and is a no-op without one; the port runs on one
device, where it is a no-op too.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import blocks as B
from .common import ModelConfig, act_fn


#: The list that :func:`record_balance` opened, or None.
_BALANCE = contextvars.ContextVar("moe_balance", default=None)


@contextlib.contextmanager
def record_balance():
    """While open, each MoE layer's forward appends its load-balance terms
    ``(me, ce)`` to the list this yields, in layer order: ``me`` [E] the
    mean router probability (with its gradient), ``ce`` [E] the fraction of
    top-k assignments per expert. A sharded step averages them over the
    data ranks before it forms ``moe_aux``, which is not a mean of the
    ranks' own. A backward's recomputation runs outside it."""
    rec = []
    token = _BALANCE.set(rec)
    try:
        yield rec
    finally:
        _BALANCE.reset(token)


class Router(nn.Module):
    """``w`` [d, E], float32 whatever the model's dtype."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.w = B._param((cfg.d_model, cfg.moe.num_experts), torch.float32,
                          device, generator)


class MoE(nn.Module):
    """``router.w`` [d, E] (float32), ``w_gate``/``w_up`` [E, d, f],
    ``w_down`` [E, f, d] and, with ``num_shared``, ``shared`` (a gated MLP
    of width ``num_shared * d_ff_expert``). The reference's parameter
    paths, so a reference tree loads leaf for leaf."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        m = cfg.moe
        e, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.router = Router(cfg, generator=generator, device=device)
        self.w_gate = B._param((e, d, f), dt, device, generator)
        self.w_up = B._param((e, d, f), dt, device, generator)
        self.w_down = B._param((e, f, d), dt, device, generator)
        self.shared = (B.MLP(cfg, d_ff=m.num_shared * f, glu=True,
                             generator=generator, device=device)
                       if m.num_shared else None)

    def forward(self, x):
        return apply(self, self.cfg, x)


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert and group for a group of ``t`` tokens."""
    m = cfg.moe
    cap = max(1, math.ceil(m.top_k * t * m.capacity_factor / m.num_experts))
    return min(cap, t * m.top_k)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w, cfg: ModelConfig, x):
    """The router and the capacity cut. x [g, t, d] -> dict with ``probs``
    [g, t, E] (f32), ``topw``/``topi`` [g, t, k] (renormalised weights,
    expert ids), ``mypos`` [g, t * k] (each assignment's position in its
    expert, token-major order) and ``cap``."""
    m = cfg.moe
    g, t, _ = x.shape
    e, k = m.num_experts, m.top_k
    cap = capacity(cfg, t)
    probs = torch.softmax(x.float() @ router_w, dim=-1)              # [g,t,e]
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    fe = topi.reshape(g, t * k)
    fw = topw.reshape(g, t * k)
    if m.dispatch_order == "criticality":
        # the weight enters the key without a gradient (stop_gradient)
        key = fe.float() * 2.0 + (1.0 - fw.detach())
        order = torch.argsort(key, dim=1, stable=True)               # [g,tk]
        fe_srt = torch.gather(fe, 1, order)
        oh = F.one_hot(fe_srt, e)
        pos_srt = torch.gather(torch.cumsum(oh, 1) - 1, 2,
                               fe_srt[..., None])[..., 0]
        # the inverse permutation, by a scatter of positions; the reference
        # argsorts ``order`` (a permutation: the same result)
        inv = torch.empty_like(order).scatter_(
            1, order, torch.arange(t * k, device=x.device).expand(g, -1))
        mypos = torch.gather(pos_srt, 1, inv)
    elif m.dispatch_order == "arrival":
        oh = F.one_hot(fe, e)
        mypos = torch.gather(torch.cumsum(oh, 1) - 1, 2, fe[..., None])[..., 0]
    else:
        raise ValueError(f"unknown dispatch_order {m.dispatch_order!r}")
    return {"probs": probs, "topw": topw, "topi": topi, "mypos": mypos,
            "cap": cap}


def apply(params: MoE, cfg: ModelConfig, x):
    """x: [b, t, d] -> ([b, t, d], {"moe_aux", "moe_dropped"}), both
    float32 scalars (tensors on x's device)."""
    m = cfg.moe
    act = act_fn(cfg.act)
    g, t, d = x.shape
    e, k = m.num_experts, m.top_k
    r = route(params.router.w, cfg, x)
    cap, topi = r["cap"], r["topi"]
    fe = topi.reshape(g, t * k)
    fw = r["topw"].reshape(g, t * k)
    keep = r["mypos"] < cap
    dropped = (~keep).sum()

    # dispatch tables: token index (t = the pad row) and combine weight per
    # (expert, slot). A dropped assignment is written to a spare expert row
    # E at slot 0, which is cut off (the reference's out-of-bounds expert id
    # under mode="drop"); kept assignments have distinct (expert, slot)s.
    # No boolean indexing, so nothing waits for the card.
    dev = x.device
    gi = torch.arange(g, device=dev)[:, None].expand(g, t * k)
    ei = torch.where(keep, fe, e)
    pi = torch.where(keep, r["mypos"], 0)
    tok = torch.arange(t, device=dev).repeat_interleave(k).expand(g, -1)
    idx_table = torch.full((g, e + 1, cap), t, dtype=torch.int64, device=dev)
    idx_table.index_put_((gi, ei, pi), tok)
    w_table = torch.zeros((g, e + 1, cap), dtype=torch.float32, device=dev)
    w_table.index_put_((gi, ei, pi), fw)
    idx_table, w_table = idx_table[:, :e], w_table[:, :e]

    xpad = torch.cat([x, x.new_zeros(g, 1, d)], dim=1)
    grp = torch.arange(g, device=dev)[:, None, None]
    xe = xpad[grp, idx_table]                                       # [g,e,cap,d]
    h = act(torch.einsum("gecd,edf->gecf", xe, params.w_gate)) * torch.einsum(
        "gecd,edf->gecf", xe, params.w_up)
    oe = torch.einsum("gecf,efd->gecd", h, params.w_down)           # [g,e,cap,d]
    oe = oe * w_table[..., None].to(oe.dtype)

    out = torch.zeros((g, t + 1, d), dtype=oe.dtype, device=dev)
    out.index_put_((grp.expand_as(idx_table), idx_table), oe, accumulate=True)
    out = out[:, :t]
    if params.shared is not None:
        out = out + params.shared(x)

    # Switch-style load-balance loss (mean over groups).
    me = r["probs"].mean(dim=(0, 1))                                # [e]
    ce = F.one_hot(topi, e).sum(2).float().mean(dim=(0, 1))         # [e]
    aux = e * torch.sum(me * ce)
    rec = _BALANCE.get()
    if rec is not None:
        rec.append((me, ce))
    return out.to(x.dtype), {"moe_aux": aux, "moe_dropped": dropped.float()}
