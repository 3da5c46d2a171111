"""O(degree) incremental surrogate features for single-item moves, as in the
reference package.

A placement annealer proposes ~10^5-10^6 single-node moves — far too many
for full re-extraction, but each move ``i: p -> q`` only touches

  * the hop terms of the edges incident to ``i`` (traffic, inject/eject,
    ring loads) — O(degree) via the same padded incidence-table gather the
    annealer's cost delta uses;
  * two entries of every per-PE accumulator (loads / counts / depth
    histogram) — O(1) scatters;
  * the max / sum-of-squares readouts — O(P) reductions over the carried
    per-PE vectors (P = grid size, tiny next to E).

:func:`apply_move` therefore maintains a :class:`GuideState` of carried
integer accumulators and returns the *exact* post-move feature vector: after
any accepted-move sequence the carried features equal a fresh
``features_batch`` bit for bit. These are the plain version of the guided
anneal kernel's feature update (``kernels/csrc/anneal.cu``, ``GUIDED``).

Integer-quantized guide
-----------------------
A fitted ridge model predicts ``y_mean + ((f - mu) / sigma) @ beta``; for a
move only the *delta* matters and the affine parts cancel::

    pred(new) - pred(old) = sum_j (beta_j / sigma_j) * (f_new_j - f_old_j)

Feature deltas are exact int64, but ``beta/sigma`` is float64, so
:func:`build_guide` quantizes ``gamma = beta/sigma`` to integers (``gamma_q
= rint(gamma * GUIDE_SCALE)``), and the whole two-stage accept — surrogate
gate *and* integer cost threshold — is int64 arithmetic (``dscore`` wraps
as two's complement, as XLA's int64 does).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .features import (
    DEPTH_BUCKETS,
    FeatureExtractor,
    _scatter,
    assemble_features,
    coarsen_extractor,
)
from .model import SurrogateModel

#: fixed-point scale of the quantized guide coefficients: predicted-cycle
#: deltas (and ``guide_margin``) are compared in units of 1/GUIDE_SCALE
#: cycles.
GUIDE_SCALE = 1 << 16


@dataclasses.dataclass(frozen=True)
class Guide:
    """A fitted surrogate, reduced to what move scoring needs.

    ``gamma_q`` are the integer-quantized per-feature slopes; the extractor
    supplies the static tables the deltas are computed from. Build with
    :func:`build_guide`; derive a coarse-level guide for a cluster quotient
    graph with :meth:`coarsen` (same slopes — quotient features are exactly
    the projected fine features, see
    :func:`repro_torch.surrogate.features.coarsen_extractor`).
    """

    extractor: FeatureExtractor
    gamma_q: np.ndarray   # [F] int64, rint(beta / sigma * GUIDE_SCALE)

    def coarsen(self, clusters: np.ndarray) -> "Guide":
        return Guide(extractor=coarsen_extractor(self.extractor, clusters),
                     gamma_q=self.gamma_q)


def build_guide(model: SurrogateModel) -> Guide:
    """Quantize a fitted :class:`SurrogateModel` into an annealer guide."""
    gamma = np.asarray(model.beta, np.float64) / np.asarray(model.sigma,
                                                            np.float64)
    return Guide(extractor=model.extractor,
                 gamma_q=np.rint(gamma * GUIDE_SCALE).astype(np.int64))


def quantize_margin(margin: float) -> int:
    """``guide_margin`` (predicted cycles) -> the int64 gate threshold
    (``+inf`` -> int64 max, ``-inf`` -> int64 min)."""
    if not np.isfinite(margin):
        return int(np.iinfo(np.int64).max) if margin > 0 \
            else int(np.iinfo(np.int64).min)
    return int(np.rint(float(margin) * GUIDE_SCALE))


class GuideArrays(NamedTuple):
    """Static tables of a :class:`Guide`.

    Raw ``[E]``/``[N]`` tables drive the O(E) :func:`state_init`; the
    ``*_inc [N, D]`` incidence-layout tables (one row per item, padded to the
    max total degree, zero-weight entries are padding) drive the O(degree)
    :func:`apply_move` gathers, exactly like the annealer's cost tables.
    :func:`guide_arrays` builds them as host numpy; :func:`to_device` moves
    them to torch tensors on a device.
    """

    src: np.ndarray        # [E] int32
    dst: np.ndarray        # [E] int32
    w_edge: np.ndarray     # [E] int64
    c_unit: np.ndarray     # [E] int64
    e_unit: np.ndarray     # [E] int64
    w_node: np.ndarray     # [N] int64
    n_unit: np.ndarray     # [N] int64
    w_bucket: np.ndarray   # [N, DEPTH_BUCKETS] int64
    nbr: np.ndarray        # [N, D] int32 incident-edge other endpoint
    out_inc: np.ndarray    # [N, D] bool: item is the edge source
    w_inc: np.ndarray      # [N, D] int64 edge weight (0 = padding)
    c_inc: np.ndarray      # [N, D] int64 critical-edge multiplicity
    u_inc: np.ndarray      # [N, D] int64 edge multiplicity
    gamma_q: np.ndarray    # [F] int64


class GuideState(NamedTuple):
    """Carried per-placement feature accumulators + the assembled features,
    each with the placements' leading axes."""

    t_w: torch.Tensor       # [...] int64 weighted hop traffic
    t_u: torch.Tensor       # [...] int64 unweighted hop traffic
    t_c: torch.Tensor       # [...] int64 critical-chain hop traffic
    loads: torch.Tensor     # [..., P] int64 criticality-weighted load
    counts: torch.Tensor    # [..., P] int64 item-count load
    inject: torch.Tensor    # [..., P] int64 remote packets leaving
    eject: torch.Tensor     # [..., P] int64 remote packets landing
    ring_x: torch.Tensor    # [..., ny] int64 X-ring hop-weighted traffic
    ring_y: torch.Tensor    # [..., nx] int64 Y-ring hop-weighted traffic
    lvl: torch.Tensor       # [..., DEPTH_BUCKETS, P] int64 per-level load
    feats: torch.Tensor     # [..., F] int64 assembled feature vector


def guide_arrays(guide: Guide) -> GuideArrays:
    """Pack a :class:`Guide` into its tables (host-side, once per search)."""
    # Deferred import: repro_torch.place imports this module's consumers;
    # the incidence builders live with the annealer they were made for.
    from ..place.anneal import (incidence_from_edges, incidence_layout,
                                incidence_payload)

    ex = guide.extractor
    n = ex.num_items
    # One O(E log E) layout sort serves all three incidence tables.
    layout = incidence_layout(ex.src, ex.dst, n)
    nbr, w_inc, out_inc = incidence_from_edges(ex.src, ex.dst, ex.w_edge, n,
                                               layout=layout)
    c_inc = incidence_payload(ex.src, ex.dst, ex.c_unit, n, layout=layout)
    u_inc = incidence_payload(ex.src, ex.dst, ex.e_unit, n, layout=layout)
    i64 = lambda a: np.asarray(a, np.int64)
    return GuideArrays(
        src=np.asarray(ex.src), dst=np.asarray(ex.dst),
        w_edge=i64(ex.w_edge), c_unit=i64(ex.c_unit), e_unit=i64(ex.e_unit),
        w_node=i64(ex.w_node), n_unit=i64(ex.n_unit),
        w_bucket=i64(ex.w_bucket),
        nbr=np.asarray(nbr), out_inc=np.asarray(out_inc),
        w_inc=i64(w_inc),
        c_inc=i64(c_inc), u_inc=i64(u_inc),
        gamma_q=i64(guide.gamma_q),
    )


def to_device(ga: GuideArrays, device) -> GuideArrays:
    """The same tables as torch tensors on ``device`` (indices and weights
    int64, ``out_inc`` bool); tensors already there are kept."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(
            a if a.dtype == bool else a.astype(np.int64))).to(device)
    return GuideArrays(*(t(a) for a in ga))


def state_init(ga: GuideArrays, pe, *, nx: int, ny: int) -> GuideState:
    """Full O(E) feature-state computation of ``[..., N]`` placements;
    arithmetic mirrors :meth:`FeatureExtractor.features_batch` term for
    term."""
    pe = torch.as_tensor(pe)
    ga = to_device(ga, pe.device)
    P = nx * ny
    pe = pe.to(torch.int64)
    ps, pd = pe[..., ga.src], pe[..., ga.dst]
    sx, sy = ps // ny, ps % ny
    dx, dy = pd // ny, pd % ny
    hx = (dx - sx) % nx
    hy = (dy - sy) % ny
    hops = hx + hy
    remote = (hops > 0).to(torch.int64)

    t_w = (ga.w_edge * hops).sum(-1)
    t_u = (ga.e_unit * hops).sum(-1)
    t_c = (ga.c_unit * hops).sum(-1)
    loads = _scatter(pe, ga.w_node, P)
    counts = _scatter(pe, ga.n_unit, P)
    inject = _scatter(ps, ga.e_unit * remote, P)
    eject = _scatter(pd, ga.e_unit * remote, P)
    ring_x = _scatter(sy, ga.w_edge * hx, ny)
    ring_y = _scatter(dx, ga.w_edge * hy, nx)
    lead, N = tuple(pe.shape[:-1]), pe.shape[-1]
    lvl = _scatter(pe.unsqueeze(-2).expand(*lead, DEPTH_BUCKETS, N),
                   ga.w_bucket.T, P)
    feats = assemble_features(t_w, t_u, t_c, loads, counts, inject, eject,
                              ring_x, ring_y, lvl)
    return GuideState(t_w=t_w, t_u=t_u, t_c=t_c, loads=loads, counts=counts,
                      inject=inject, eject=eject, ring_x=ring_x,
                      ring_y=ring_y, lvl=lvl, feats=feats)


def _add(base, index, values):
    """A copy of ``base`` with ``values`` added at ``index`` (last axis)."""
    return base.clone().scatter_add_(-1, index, values)


def apply_move(ga: GuideArrays, st: GuideState, pe, i, q,
               *, nx: int, ny: int) -> tuple[GuideState, torch.Tensor]:
    """Tentative post-move state of ``i -> q`` plus the quantized score, per
    placement: ``pe`` [..., N], ``i`` and ``q`` [...] (or scalars).

    Returns ``(new_state, dscore_q)`` where ``dscore_q = gamma_q @ (f_new -
    f_old)`` — ``GUIDE_SCALE`` times the predicted cycle delta, exact int64
    (wrapping). The caller commits or discards the state based on its accept
    rule. Only ``i``'s incident edges are gathered — O(degree) — plus O(P)
    reductions for the max/sum-of-squares readouts.
    """
    pe = torch.as_tensor(pe)
    ga = to_device(ga, pe.device)
    pe = pe.to(torch.int64)
    lead = tuple(pe.shape[:-1])
    i = torch.as_tensor(i, device=pe.device).to(torch.int64).expand(lead)
    q = torch.as_tensor(q, device=pe.device).to(torch.int64).expand(lead)
    p = pe.gather(-1, i.unsqueeze(-1)).squeeze(-1)
    nb, out = ga.nbr[i], ga.out_inc[i]
    w, cu, uu = ga.w_inc[i], ga.c_inc[i], ga.u_inc[i]   # 0 on padding
    o = pe.gather(-1, nb)
    ox, oy = o // ny, o % ny
    p_, q_ = p.unsqueeze(-1), q.unsqueeze(-1)
    px, py = p_ // ny, p_ % ny
    qx, qy = q_ // ny, q_ % ny

    # Dimension-ordered hops per incident edge, before/after the move: for
    # out-edges i is the source (hx = dst_x - src_x mod nx), for in-edges the
    # destination. Padding entries carry weight/multiplicity 0 everywhere
    # they are summed or scattered, so they contribute nothing.
    hx_old = torch.where(out, (ox - px) % nx, (px - ox) % nx)
    hy_old = torch.where(out, (oy - py) % ny, (py - oy) % ny)
    hx_new = torch.where(out, (ox - qx) % nx, (qx - ox) % nx)
    hy_new = torch.where(out, (oy - qy) % ny, (qy - oy) % ny)
    h_old, h_new = hx_old + hy_old, hx_new + hy_new
    dh = h_new - h_old
    r_old = (h_old > 0).to(torch.int64)
    r_new = (h_new > 0).to(torch.int64)

    src_old = torch.where(out, p_, o)
    src_new = torch.where(out, q_, o)
    dst_old = torch.where(out, o, p_)
    dst_new = torch.where(out, o, q_)

    t_w = st.t_w + (w * dh).sum(-1)
    t_u = st.t_u + (uu * dh).sum(-1)
    t_c = st.t_c + (cu * dh).sum(-1)
    inject = _add(st.inject, src_old, -uu * r_old).scatter_add_(
        -1, src_new, uu * r_new)
    eject = _add(st.eject, dst_old, -uu * r_old).scatter_add_(
        -1, dst_new, uu * r_new)
    ring_x = _add(st.ring_x, src_old % ny, -w * hx_old).scatter_add_(
        -1, src_new % ny, w * hx_new)
    ring_y = _add(st.ring_y, dst_old // ny, -w * hy_old).scatter_add_(
        -1, dst_new // ny, w * hy_new)

    wn, nu = ga.w_node[i].unsqueeze(-1), ga.n_unit[i].unsqueeze(-1)
    loads = _add(st.loads, p_, -wn).scatter_add_(-1, q_, wn)
    counts = _add(st.counts, p_, -nu).scatter_add_(-1, q_, nu)
    b = ga.w_bucket[i].unsqueeze(-1)                  # [..., DEPTH_BUCKETS, 1]
    at = lambda x: x.unsqueeze(-1).expand(*lead, DEPTH_BUCKETS, 1)
    lvl = _add(st.lvl, at(p_), -b).scatter_add_(-1, at(q_), b)

    feats = assemble_features(t_w, t_u, t_c, loads, counts, inject, eject,
                              ring_x, ring_y, lvl)
    dscore = (ga.gamma_q * (feats - st.feats)).sum(-1)
    new = GuideState(t_w=t_w, t_u=t_u, t_c=t_c, loads=loads, counts=counts,
                     inject=inject, eject=eject, ring_x=ring_x,
                     ring_y=ring_y, lvl=lvl, feats=feats)
    return new, dscore
