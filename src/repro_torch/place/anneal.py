"""Batched parallel-tempering placer, as in the reference package.

Search shape
------------
``replicas`` candidate placements evolve side by side. Each replica runs
*threshold accepting* — the deterministic simulated-annealing variant: a
proposed single-node move is accepted iff its integer cost delta is
``<= threshold[r]`` — with thresholds laddered geometrically from ``t_max``
(hot, explores) down to 0 (cold, pure greedy). Every round (``steps``
proposals per replica) a parallel-tempering exchange runs across adjacent
ladder rungs: the lower-cost configuration migrates toward the cold end, so
discoveries made while hot get polished greedily without restarts.

Determinism
-----------
Costs, deltas and accept decisions are int64 arithmetic on int32 tables
(:mod:`repro_torch.place.cost`), and proposals come from the counter-based
Threefry stream of :mod:`repro_torch.core.prng` (the reference's
``jax.random`` stream, non-partitionable layout), so for a fixed
:class:`~repro_torch.place.spec.AnnealConfig` the result equals the
reference's bit for bit: best placements, best costs and the init cost.

Move evaluation is O(degree), not O(E): moving node ``v`` only re-prices the
edges incident to ``v`` (gathered from a padded host-built incidence table)
plus a two-PE load update — the carried per-PE load vector makes the
quadratic pressure delta ``2 w (load[q] - load[p] + w)``.

Engines: the search of ``Q`` ladders (:func:`anneal_tables_many`; one for
:func:`anneal_tables`) runs through
:func:`repro_torch.kernels.anneal.anneal_ladders`, which launches the CUDA
kernel of ``kernels/csrc/anneal.cu`` for tensors on the card and runs
:func:`anneal_plain` — torch ops over ``[Q, R, N]`` — for tensors on the
CPU. The surrogate-guided search (``guide=``) runs the same way: the
kernel's ``GUIDED`` instantiation on the card, :func:`anneal_guided_plain`
on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import resolve_device
from ..core import prng
from ..core.graph import DataflowGraph
from .cost import CostModel, build_cost_model, edge_endpoints, torus_hops
from .spec import AnnealConfig


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    """Best placement found plus search diagnostics."""

    node_pe: np.ndarray        # [N] int32 node -> PE
    cost: int                  # integer model cost of node_pe
    init_cost: int             # cost of the initial placement
    replica_costs: np.ndarray  # [R] per-replica best costs (ladder health)

    @property
    def improvement(self) -> float:
        return 1.0 - self.cost / max(1, self.init_cost)


@dataclasses.dataclass(frozen=True)
class GuidedPlacementResult(PlacementResult):
    """:class:`PlacementResult` of a surrogate-guided search.

    ``cost_evals`` counts the proposals that passed the surrogate gate and
    therefore reached the integer cost/accept rule (ungated proposals under
    ``guide_every > 1`` count too); ``proposals`` is the total budget
    ``replicas * rounds * steps`` — what an *unguided* run of the same
    config would have cost-evaluated. Both are exact deterministic integers.

    The counter is an *accounting* metric: every proposal still pays its
    cost delta and, in addition, the O(degree) + O(P) surrogate update, so
    a guided proposal takes more time than an unguided one, not less.
    """

    cost_evals: int = 0
    proposals: int = 0

    @property
    def eval_ratio(self) -> float:
        return self.cost_evals / max(1, self.proposals)


def incidence_table(g: DataflowGraph, w_edge: np.ndarray):
    """Padded per-node incident-edge table for O(degree) move deltas.

    Returns ([N, D] neighbor node, [N, D] int32 edge weight — 0 marks
    padding, [N, D] bool "node is the edge source"). D = max total degree
    (fanin <= 2, fanout unbounded).
    """
    src, dst = edge_endpoints(g)
    return incidence_from_edges(src, dst, w_edge, g.num_nodes)


def incidence_layout(src: np.ndarray, dst: np.ndarray, n: int):
    """Shared incidence layout: each edge appears once per endpoint.

    Returns ``(owner, pos, order, d_max)`` — the owning node of each
    (sorted) entry, its position within the owner's row, the sort
    permutation over the doubled ``[src; dst]`` edge list, and the padded
    row width. Both the weight tables (:func:`incidence_from_edges`) and
    arbitrary per-edge payloads (:func:`incidence_payload`) scatter through
    this one layout, so their entries line up index-for-index.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    owner = np.concatenate([src, dst])
    order = np.argsort(owner, kind="stable")
    owner = owner[order]
    m = owner.shape[0]
    # Position of each entry within its owner's group: running index minus
    # the group's start index.
    starts = np.zeros(m, dtype=np.int64)
    if m:
        group_start = np.r_[0, np.flatnonzero(np.diff(owner)) + 1]
        starts[group_start] = group_start
        starts = np.maximum.accumulate(starts)
    pos = np.arange(m) - starts
    d_max = max(1, int(pos.max(initial=0)) + 1)
    return owner, pos, order, d_max


def incidence_from_edges(src: np.ndarray, dst: np.ndarray,
                         w_edge: np.ndarray, n: int, *, layout=None):
    """:func:`incidence_table` over flat ``(src, dst)`` edge arrays — the
    entry point the multilevel coarsener (:mod:`repro_torch.place.coarsen`)
    uses to anneal cluster-level quotient graphs."""
    w_edge = np.asarray(w_edge, dtype=np.int32)
    other = np.concatenate([np.asarray(dst, np.int64),
                            np.asarray(src, np.int64)]).astype(np.int32)
    w = np.concatenate([w_edge, w_edge])
    out = np.concatenate([np.ones(len(w_edge), bool),
                          np.zeros(len(w_edge), bool)])

    owner, pos, order, d_max = layout or incidence_layout(src, dst, n)
    nbr = np.zeros((n, d_max), dtype=np.int32)
    w_pad = np.zeros((n, d_max), dtype=np.int32)
    is_out = np.zeros((n, d_max), dtype=bool)
    nbr[owner, pos] = other[order]
    w_pad[owner, pos] = w[order]
    is_out[owner, pos] = out[order]
    return nbr, w_pad, is_out


def incidence_payload(src: np.ndarray, dst: np.ndarray,
                      values: np.ndarray, n: int, *, layout=None) -> np.ndarray:
    """[N, D] per-incident-edge payload table in the exact layout of
    :func:`incidence_from_edges` (0 marks padding)."""
    values = np.asarray(values)
    owner, pos, order, d_max = layout or incidence_layout(src, dst, n)
    out = np.zeros((n, d_max), dtype=values.dtype)
    out[owner, pos] = np.concatenate([values, values])[order]
    return out


# ---------------------------------------------------------------------------
# The search's pieces, batched over leading axes (ladders, replicas).
# ---------------------------------------------------------------------------

def _pe_loads(pe, w_node, num_pes: int):
    """[..., P] int64 criticality-weighted item load per PE of [..., N]
    placements."""
    pe = pe.to(torch.int64)
    out = torch.zeros(*pe.shape[:-1], num_pes, dtype=torch.int64,
                      device=pe.device)
    return out.scatter_add_(-1, pe, w_node.to(torch.int64).expand(pe.shape))


def _placement_cost(pe, nbr, w_inc, is_out, w_node, pw, nx: int, ny: int):
    """[...] int64 full model cost of [..., N] placements (traffic +
    pressure).

    Each incidence entry appears once per endpoint; out-edges only, so
    every edge is counted exactly once. Padding gathers are clipped into
    ``[0, N)`` (their weight is 0)."""
    pe = pe.to(torch.int64)
    n = pe.shape[-1]
    idx = nbr.to(torch.int64).clamp(0, n - 1).reshape(-1)
    nbr_pe = pe[..., idx].reshape(*pe.shape, nbr.shape[-1])
    hop = torus_hops(pe.unsqueeze(-1), nbr_pe, nx, ny)
    w = torch.where(is_out, w_inc, 0).to(torch.int64)
    traffic = (w * hop).sum((-1, -2))
    loads = _pe_loads(pe, w_node, nx * ny)
    return traffic + pw * (loads * loads).sum(-1)


def _move_delta(pe, load, i, q, nbr, w_inc, is_out, w_node, pw,
                nx: int, ny: int):
    """O(degree) integer cost delta of moving item ``i`` to PE ``q``, per
    replica: ``pe`` [..., N], ``load`` [..., P], ``i``/``q`` [...].

    Returns ``(delta, p, wn)`` — the delta, the item's current PE, and its
    int64 weight (what the accept commit needs)."""
    i = i.to(torch.int64)
    q = q.to(torch.int64)
    p = pe.gather(-1, i.unsqueeze(-1)).squeeze(-1).to(torch.int64)
    nb, wv, out = nbr[i].to(torch.int64), w_inc[i], is_out[i]
    nbr_pe = pe.gather(-1, nb).to(torch.int64)
    p_, q_ = p.unsqueeze(-1), q.unsqueeze(-1)
    old_h = torch.where(out, torus_hops(p_, nbr_pe, nx, ny),
                        torus_hops(nbr_pe, p_, nx, ny))
    new_h = torch.where(out, torus_hops(q_, nbr_pe, nx, ny),
                        torus_hops(nbr_pe, q_, nx, ny))
    d_traffic = (wv.to(torch.int64) * (new_h - old_h)).sum(-1)
    wn = w_node[i].to(torch.int64)
    lq = load.gather(-1, q_).squeeze(-1)
    lp = load.gather(-1, p_).squeeze(-1)
    d_pressure = 2 * wn * (lq - lp + wn)
    return d_traffic + pw * d_pressure, p, wn


def _pt_take(costs, parity: int):
    """[..., R] replica-permutation indices of one parallel-tempering
    exchange: the lower-cost configuration of each adjacent ladder pair
    migrates toward the cold (low-r) end."""
    R = costs.shape[-1]
    r = torch.arange(R, device=costs.device)
    off = r - parity
    partner = torch.where(off < 0, r, torch.where(off % 2 == 0, r + 1, r - 1))
    partner = partner.clamp(0, R - 1)
    lo = torch.minimum(r, partner)
    hi = torch.maximum(r, partner)
    swap = (partner != r) & (costs[..., hi] < costs[..., lo])
    return torch.where(swap, partner, r)


def _thresholds(acfg: AnnealConfig) -> np.ndarray:
    """[R] int64 acceptance thresholds: 0 (greedy) then geometric to t_max."""
    r = acfg.replicas
    t = float(acfg.t_max)
    if r == 1 or t <= 0:
        return np.zeros(r, dtype=np.int64)
    if r == 2:
        ladder = np.array([t])          # single hot rung sits AT t_max
    else:
        ladder = np.geomspace(min(2.0, t), t, r - 1)
    return np.concatenate([[0], np.rint(ladder).astype(np.int64)])


def ladder_start(init_pe, nbr, w_inc, is_out, w_node, replicas: int,
                 nx: int, ny: int, pressure_weight: int):
    """Every ladder's start: ``[Q, R, N]`` placements (the init on every
    rung), their ``[Q, R, P]`` loads and ``[Q, R]`` costs, in new tensors."""
    init_pe = init_pe.to(torch.int32)
    load = _pe_loads(init_pe, w_node, nx * ny)
    cost = _placement_cost(init_pe, nbr, w_inc, is_out, w_node,
                           int(pressure_weight), nx, ny)
    # repeat copies (at one replica too), so a search that updates the rows
    # in place leaves the caller's init alone
    return (init_pe.unsqueeze(1).repeat(1, replicas, 1),
            load.unsqueeze(1).repeat(1, replicas, 1),
            cost.unsqueeze(1).repeat(1, replicas))


def round_proposals(keys, steps: int, n: int, num_pes: int):
    """One round's proposals of every replica: ``keys`` [..., 2] (the
    replicas' chain keys) -> (``i`` [steps, ...] int32 items, ``q``
    [steps, ...] int32 PEs, the chain keys after the round).

    Each step splits the chain key into (step key, next chain key), splits
    the step key into (k1, k2) and draws ``i = randint(k1, 0, n)`` and
    ``q = randint(k2, 0, num_pes)`` — the reference's proposal. The chain
    is serial; the draws of the round run as one batch."""
    step_keys = []
    for _ in range(steps):
        new = prng.split(keys, 2)
        step_keys.append(new[..., 0, :])
        keys = new[..., 1, :]
    k = prng.split(torch.stack(step_keys), 2)
    i = prng.randint(k[..., 0, :], (), 0, n)
    q = prng.randint(k[..., 1, :], (), 0, num_pes)
    return i, q, keys


def anneal_plain(init_pe, nbr, w_inc, is_out, w_node, thresholds, keys, *,
                 nx: int, ny: int, rounds: int, steps: int,
                 pressure_weight: int):
    """The reference's ``_anneal_jit`` over ``Q`` independent ladders, in
    torch ops: ``init_pe`` [Q, N] int32, ``thresholds`` [Q, R] int64,
    ``keys`` [Q, 2] (each ladder's root key, :func:`prng.key` words).

    Returns (``best_pe`` [Q, R, N] int32, ``best_cost`` [Q, R] int64,
    ``init_cost`` [Q] int64). The plain version of the CUDA kernel of
    :mod:`repro_torch.kernels.anneal`."""
    Q, N = init_pe.shape
    R = thresholds.shape[-1]
    P = nx * ny
    pw = int(pressure_weight)
    pe, load, cost = ladder_start(init_pe, nbr, w_inc, is_out, w_node, R,
                                  nx, ny, pw)
    cost0, best_pe, best_cost = cost, pe.clone(), cost
    keys = prng.split(keys, R)                          # [Q, R, 2]
    thresholds = thresholds.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=pe.device)
    for rnd in range(rounds):
        items, pes, keys = round_proposals(keys, steps, N, P)
        for t in range(steps):
            i, q = items[t].to(torch.int64), pes[t].to(torch.int64)
            delta, p, wn = _move_delta(pe, load, i, q, nbr, w_inc, is_out,
                                       w_node, pw, nx, ny)
            accept = (delta <= thresholds) & (p != q)
            pe.scatter_(-1, i.unsqueeze(-1),
                        torch.where(accept, q, p).to(torch.int32).unsqueeze(-1))
            load.scatter_add_(-1, p.unsqueeze(-1),
                              torch.where(accept, -wn, zero).unsqueeze(-1))
            load.scatter_add_(-1, q.unsqueeze(-1),
                              torch.where(accept, wn, zero).unsqueeze(-1))
            cost = cost + torch.where(accept, delta, zero)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_pe = torch.where(better.unsqueeze(-1), pe, best_pe)
        take = _pt_take(cost, rnd % 2)
        pe = pe.gather(1, take.unsqueeze(-1).expand_as(pe)).contiguous()
        cost = cost.gather(1, take)
        load = _pe_loads(pe, w_node, P)
    return best_pe, best_cost, cost0[:, 0]


def anneal_guided_plain(init_pe, nbr, w_inc, is_out, w_node, thresholds,
                        keys, ga, q_margin: int, *, nx: int, ny: int,
                        rounds: int, steps: int, pressure_weight: int,
                        guide_every: int):
    """The reference's ``_anneal_guided_jit`` over ``Q`` ladders, in torch
    ops: :func:`anneal_plain` with the two-stage accept.

    Every proposal is first scored by the integer-quantized surrogate through
    the O(degree) incremental feature update
    (:func:`repro_torch.surrogate.delta.apply_move`, over the guide's tables
    ``ga``); on the round's steps ``j`` with ``j % guide_every == 0`` only
    proposals with ``dscore <= q_margin`` (int64) are *promising*, on the
    others every proposal is. Only promising proposals reach the unguided
    search's integer cost/accept rule; ``evals`` counts them per rung (the
    counter belongs to the rung and is not permuted by the exchange, while
    the guide state travels with its configuration). The key chain, the cost
    arithmetic, the best tracking and the exchange are :func:`anneal_plain`'s,
    so with the gate wide open (``q_margin`` = int64 max) the search equals
    it.

    Returns (``best_pe`` [Q, R, N] int32, ``best_cost`` [Q, R] int64,
    ``init_cost`` [Q] int64, ``evals`` [Q, R] int64). The plain version of
    the kernel's ``GUIDED`` instantiation."""
    from ..surrogate.delta import (GuideState, apply_move, state_init,
                                   to_device)

    Q, N = init_pe.shape
    R = thresholds.shape[-1]
    P = nx * ny
    pw = int(pressure_weight)
    pe, load, cost = ladder_start(init_pe, nbr, w_inc, is_out, w_node, R,
                                  nx, ny, pw)
    cost0, best_pe, best_cost = cost, pe.clone(), cost
    ga = to_device(ga, pe.device)
    gst = state_init(ga, pe, nx=nx, ny=ny)
    evals = torch.zeros(Q, R, dtype=torch.int64, device=pe.device)
    keys = prng.split(keys, R)                          # [Q, R, 2]
    thresholds = thresholds.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=pe.device)
    ladders = torch.arange(Q, device=pe.device).unsqueeze(-1)
    for rnd in range(rounds):
        items, pes, keys = round_proposals(keys, steps, N, P)
        for j in range(steps):
            i, q = items[j].to(torch.int64), pes[j].to(torch.int64)
            # stage 1: the surrogate gate (exact incremental features)
            new, dscore = apply_move(ga, gst, pe, i, q, nx=nx, ny=ny)
            if j % guide_every == 0:
                promising = dscore <= q_margin
            else:
                promising = torch.ones_like(dscore, dtype=torch.bool)
            # stage 2: the unguided search's integer cost/threshold accept
            delta, p, wn = _move_delta(pe, load, i, q, nbr, w_inc, is_out,
                                       w_node, pw, nx, ny)
            accept = promising & (delta <= thresholds) & (p != q)
            pe.scatter_(-1, i.unsqueeze(-1),
                        torch.where(accept, q, p).to(torch.int32).unsqueeze(-1))
            load.scatter_add_(-1, p.unsqueeze(-1),
                              torch.where(accept, -wn, zero).unsqueeze(-1))
            load.scatter_add_(-1, q.unsqueeze(-1),
                              torch.where(accept, wn, zero).unsqueeze(-1))
            cost = cost + torch.where(accept, delta, zero)
            gst = GuideState(*(torch.where(
                accept.reshape(accept.shape + (1,) * (a.dim() - 2)), a, b)
                for a, b in zip(new, gst)))
            evals += promising.to(torch.int64)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_pe = torch.where(better.unsqueeze(-1), pe, best_pe)
        take = _pt_take(cost, rnd % 2)
        pe = pe[ladders, take].contiguous()
        cost = cost[ladders, take]
        gst = GuideState(*(a[ladders, take] for a in gst))
        load = _pe_loads(pe, w_node, P)
    return best_pe, best_cost, cost0[:, 0], evals


# ---------------------------------------------------------------------------
# Front ends.
# ---------------------------------------------------------------------------

def _check_init(init, n: int, num_pes: int, seed: int) -> np.ndarray:
    if init is None:
        rng = np.random.default_rng(seed)
        init = rng.integers(0, num_pes, size=n).astype(np.int32)
    init = np.asarray(init, dtype=np.int32)
    if init.shape != (n,):
        raise ValueError(f"init must be [{n}] item->PE, got {init.shape}")
    if init.size and (init.min() < 0 or init.max() >= num_pes):
        raise ValueError("init placement references PEs outside the grid")
    return init


def _search(n, nx, ny, src, dst, w_edge, w_node, acfgs, inits, device,
            guide=None, guide_every: int = 1, guide_margin: float = 0.0):
    """Run one ladder per config on ``device``; -> numpy (best_pe
    [Q, R, N], best_cost [Q, R], init_cost [Q]) and, with a ``guide``,
    evals [Q, R]."""
    from ..kernels import anneal as kernel

    dev = resolve_device(device)
    nbr, w_inc, is_out = incidence_from_edges(src, dst, w_edge, n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = torch.stack([prng.key(a.seed) for a in acfgs]).to(dev)
    a0 = acfgs[0]
    knobs = dict(nx=nx, ny=ny, rounds=a0.rounds, steps=a0.steps,
                 pressure_weight=a0.pressure_weight)
    if guide is not None:
        from ..surrogate.delta import guide_arrays, quantize_margin

        knobs.update(guide=guide_arrays(guide),
                     q_margin=quantize_margin(guide_margin),
                     guide_every=int(guide_every))
    out = kernel.anneal_ladders(
        t(np.stack(inits)), t(nbr), t(w_inc), t(is_out),
        t(np.asarray(w_node, np.int32)),
        t(np.stack([_thresholds(a) for a in acfgs])), keys, **knobs)
    return tuple(a.cpu().numpy() for a in out)


def _result(best_pe, best_cost, init_cost, evals=None,
            acfg: AnnealConfig | None = None) -> PlacementResult:
    b = int(best_cost.argmin())
    fields = dict(
        node_pe=best_pe[b].astype(np.int32),
        cost=int(best_cost[b]),
        init_cost=int(init_cost),
        replica_costs=best_cost.astype(np.int64))
    if evals is None:
        return PlacementResult(**fields)
    return GuidedPlacementResult(
        **fields, cost_evals=int(evals.sum()),
        proposals=acfg.replicas * acfg.rounds * acfg.steps)


def _check_guide(guide, n: int, nx: int, ny: int, guide_every: int):
    """The :class:`repro_torch.surrogate.delta.Guide` of ``guide`` (a guide
    or a fitted model) for ``n`` items on ``nx x ny``, or ``ValueError``."""
    from ..surrogate.delta import Guide, build_guide

    if not isinstance(guide, Guide):
        guide = build_guide(guide)
    ex = guide.extractor
    if ex.num_items != n or (ex.nx, ex.ny) != (nx, ny):
        raise ValueError(
            f"guide was built for {ex.num_items} items on a "
            f"{ex.nx}x{ex.ny} grid; this search places {n} items on "
            f"{nx}x{ny}")
    if guide_every < 1:
        raise ValueError(f"guide_every must be >= 1, got {guide_every}")
    return guide


def anneal_tables(
    n: int,
    nx: int,
    ny: int,
    src: np.ndarray,
    dst: np.ndarray,
    w_edge: np.ndarray,
    w_node: np.ndarray,
    acfg: AnnealConfig | None = None,
    *,
    init: np.ndarray | None = None,
    guide=None,
    guide_every: int = 1,
    guide_margin: float = 0.0,
    device=None,
) -> PlacementResult:
    """Anneal an ``[n]`` item -> PE placement from flat integer edge tables.

    ``n`` items (graph nodes — or node *clusters* in the multilevel
    pipeline) connected by ``(src, dst)`` edges of weight ``w_edge``, with
    per-item weights ``w_node``, are placed on the ``nx x ny`` torus, on
    ``device`` (``None`` = the CUDA card: the anneal kernel; ``"cpu"``: the
    plain version).

    ``guide`` switches on the two-stage surrogate accept: a
    :class:`repro_torch.surrogate.delta.Guide` (or a fitted
    :class:`~repro_torch.surrogate.model.SurrogateModel`, converted on the
    spot) built for the *same* ``n`` items on the same grid — its extractor
    may weight edges its own way, but it must describe this item set.
    Proposals whose quantized predicted-cycle delta exceeds ``guide_margin``
    (in predicted cycles; ``inf`` disables the gate) are rejected before the
    integer cost rule; ``guide_every=k`` applies the gate on every k-th
    proposal of a round only. Guided searches return a
    :class:`GuidedPlacementResult` carrying the exact cost-evaluation count.
    """
    acfg = acfg or AnnealConfig()
    init = _check_init(init, n, nx * ny, acfg.seed)
    if guide is not None:
        guide = _check_guide(guide, n, nx, ny, guide_every)
    out = _search(n, nx, ny, src, dst, w_edge, w_node, [acfg], [init], device,
                  guide=guide, guide_every=guide_every,
                  guide_margin=guide_margin)
    return _result(*(a[0] for a in out), acfg=acfg)


def anneal_tables_many(
    n: int,
    nx: int,
    ny: int,
    src: np.ndarray,
    dst: np.ndarray,
    w_edge: np.ndarray,
    w_node: np.ndarray,
    acfgs,
    *,
    inits=None,
    device=None,
) -> list[PlacementResult]:
    """Run MANY independent anneals of one item set as one search: ``Q``
    ladders, one CTA each on the card. Every element equals a solo
    :func:`anneal_tables` call with the same config.

    Static knobs must be uniform across ``acfgs``: ``replicas``, ``rounds``,
    ``steps``, ``pressure_weight``. Per-query values may vary: ``seed``
    (init + proposal stream) and ``t_max`` (thresholds ride in as data).
    """
    acfgs = list(acfgs)
    if not acfgs:
        return []
    statics = {(a.replicas, a.rounds, a.steps, a.pressure_weight)
               for a in acfgs}
    if len(statics) != 1:
        raise ValueError(
            f"anneal_tables_many needs uniform (replicas, rounds, steps, "
            f"pressure_weight) across the batch; got {sorted(statics)}. "
            f"Group queries by these knobs.")
    if inits is None:
        inits = [None] * len(acfgs)
    init_rows = [_check_init(init, n, nx * ny, a.seed)
                 for a, init in zip(acfgs, inits)]
    best_pe, best_cost, init_cost = _search(
        n, nx, ny, src, dst, w_edge, w_node, acfgs, init_rows, device)
    return [_result(best_pe[q], best_cost[q], init_cost[q])
            for q in range(len(acfgs))]


def anneal_placements(
    g: DataflowGraph,
    nx: int,
    ny: int,
    acfgs,
    *,
    metric: str = "height",
    inits=None,
    model: CostModel | None = None,
    device=None,
) -> list[PlacementResult]:
    """Many independent :func:`anneal_placement` searches as one (see
    :func:`anneal_tables_many`). All share one cost model, so ``metric``
    and the configs' ``crit_scale``/``pressure_weight`` must be uniform."""
    acfgs = [a or AnnealConfig() for a in acfgs]
    if not acfgs:
        return []
    crits = {a.crit_scale for a in acfgs}
    pws = {a.pressure_weight for a in acfgs}
    if model is None and (len(crits) != 1 or len(pws) != 1):
        raise ValueError(
            f"anneal_placements shares one cost model: crit_scale/"
            f"pressure_weight must be uniform, got {crits}/{pws}")
    model = model or build_cost_model(
        g, nx, ny, metric=metric, crit_scale=acfgs[0].crit_scale,
        pressure_weight=acfgs[0].pressure_weight, device="cpu")
    src, dst = edge_endpoints(g)
    return anneal_tables_many(
        g.num_nodes, nx, ny, src, dst, model.w_edge.cpu().numpy(),
        model.w_node.cpu().numpy(), acfgs, inits=inits, device=device)


def anneal_placement(
    g: DataflowGraph,
    nx: int,
    ny: int,
    acfg: AnnealConfig | None = None,
    *,
    metric: str = "height",
    init: np.ndarray | None = None,
    model: CostModel | None = None,
    guide=None,
    guide_every: int = 1,
    guide_margin: float = 0.0,
    device=None,
) -> PlacementResult:
    """Search a node -> PE placement for ``g`` on the ``nx x ny`` torus.

    ``init`` defaults to a uniform-random placement drawn from
    ``acfg.seed`` — the baseline the annealer is guaranteed (by best-so-far
    tracking that includes the init) to never score worse than. ``guide``
    (a fitted :class:`~repro_torch.surrogate.model.SurrogateModel` or a
    prebuilt :class:`~repro_torch.surrogate.delta.Guide` for this graph and
    grid) switches on the two-stage surrogate accept — see
    :func:`anneal_tables`.
    """
    acfg = acfg or AnnealConfig()
    model = model or build_cost_model(
        g, nx, ny, metric=metric, crit_scale=acfg.crit_scale,
        pressure_weight=acfg.pressure_weight, device="cpu")
    src, dst = edge_endpoints(g)
    return anneal_tables(
        g.num_nodes, nx, ny, src, dst, model.w_edge.cpu().numpy(),
        model.w_node.cpu().numpy(), acfg, init=init, guide=guide,
        guide_every=guide_every, guide_margin=guide_margin, device=device)
