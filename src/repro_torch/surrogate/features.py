"""Cheap, batched placement features for cycle-count prediction, as in the
reference package.

A feature vector summarizes how a candidate ``[N]`` node -> PE placement
stresses the overlay, using only static graph tables (no simulation):

  * **traffic** — hop-weighted NoC load (weighted / unweighted / critical-
    chain-only sums over the unidirectional-torus hop counts the simulator
    charges);
  * **slot pressure** — per-PE criticality-weighted load: sum of squares and
    max (each PE fires at most one node per cycle, so piled load serializes),
    plus the unweighted slot-count shape (max local memory depth);
  * **port contention** — per-PE counts of remote packets that must leave
    (inject, 1/PE/cycle) and land (eject, 1 port/PE/cycle): sum of squares
    and max of each;
  * **ring load** — traffic per X-ring / Y-ring of the Hoplite torus (a
    packet moves east along its source row, then south along its destination
    column): max and sum-of-squares of each — hot rings deflect;
  * **criticality-depth histogram** — per ASAP-depth-bucket per-PE weighted
    load, reduced to max and sum-of-squares per bucket: the dataflow wavefront
    sweeps depth levels in order, so imbalance *within* a level serializes
    that level no matter how balanced the total is.

Every term is an integer accumulation in ``torch.int64`` (``scatter_add_``
and sums), exact in any order, so the feature matrix is bit for bit the
reference's on the CPU and on the card alike; the whole batch extracts as a
few tensor ops on ``device``.

Multiplicity tables
-------------------
The extractor carries three *unit* tables that default to the trivial values
at the fine (one-row-per-graph-edge) level but let a **quotient graph** of
node clusters compute the exact same features its projected fine placement
would have (:func:`coarsen_extractor`):

  * ``e_unit``  — [E] edges represented by this (aggregated) edge (fine: 1);
  * ``c_unit``  — [E] *critical* edges represented (fine: the 0/1 crit flag);
  * ``n_unit``  — [N] nodes represented by this item (fine: 1);
  * ``w_bucket`` — [N, DEPTH_BUCKETS] criticality weight per ASAP-depth
    bucket (fine: ``w_node`` one-hot at the node's own bucket; its row sums
    always equal ``w_node``).

With cluster-aggregated units, every feature of a cluster placement equals —
bit for bit — the fine feature of the projected placement ``node_pe =
cluster_pe[clusters]`` (intra-cluster edges travel 0 hops, so dropping them
changes nothing). That exactness is what lets the multilevel placer's
*coarse* phase consult the surrogate fitted on fine placements
(:mod:`repro_torch.surrogate.delta`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import resolve_device
from ..core.criticality import asap_levels
from ..core.graph import DataflowGraph
from ..place.cost import edge_tables

#: ASAP-depth buckets in the criticality-depth histogram block.
DEPTH_BUCKETS = 8
#: Length of a feature vector: 13 scalars, then a max and a sum of squares
#: per depth bucket.
NUM_FEATURES = 13 + 2 * DEPTH_BUCKETS


def _sumsq(v):
    return (v * v).sum(-1)


def assemble_features(t_w, t_u, t_c, loads, counts, inject, eject,
                      ring_x, ring_y, lvl):
    """[..., F] int64 feature vectors from the raw accumulators (``t_*``
    [...], the per-PE vectors [..., P], the rings [..., ny] / [..., nx],
    ``lvl`` [..., DEPTH_BUCKETS, P]).

    THE single definition of the feature order — both the batch extractor
    below and the incremental delta path (:mod:`repro_torch.surrogate.delta`)
    build their vectors through it, so they cannot drift apart.
    """
    scalars = [
        t_w, t_u, t_c,
        _sumsq(loads), loads.amax(-1),
        _sumsq(counts), counts.amax(-1),
        _sumsq(inject), inject.amax(-1),
        _sumsq(eject), eject.amax(-1),
        torch.maximum(ring_x.amax(-1), ring_y.amax(-1)),
        _sumsq(ring_x) + _sumsq(ring_y),
    ]
    return torch.cat([torch.stack(scalars, -1), lvl.amax(-1), _sumsq(lvl)],
                     -1)


def _scatter(index, values, size: int):
    """[..., size] int64 sums of ``values`` at ``index`` along the last
    axis (``values`` broadcast to ``index``'s shape)."""
    out = torch.zeros(*index.shape[:-1], size, dtype=torch.int64,
                      device=index.device)
    return out.scatter_add_(-1, index, values.expand(index.shape))


@dataclasses.dataclass(frozen=True)
class FeatureExtractor:
    """Static per-graph tables + the batched feature function."""

    nx: int
    ny: int
    src: np.ndarray           # [E] int32 edge source item
    dst: np.ndarray           # [E] int32 edge destination item
    w_edge: np.ndarray        # [E] int32 criticality edge weight
    w_node: np.ndarray        # [N] int32 criticality item weight
    c_unit: np.ndarray        # [E] int32 critical fine edges represented
    e_unit: np.ndarray        # [E] int32 fine edges represented (fine: 1)
    n_unit: np.ndarray        # [N] int32 fine nodes represented (fine: 1)
    w_bucket: np.ndarray      # [N, DEPTH_BUCKETS] int32 weight per ASAP bucket

    @property
    def num_pes(self) -> int:
        return self.nx * self.ny

    @property
    def num_items(self) -> int:
        return self.w_node.shape[0]

    @property
    def num_features(self) -> int:
        return NUM_FEATURES

    def features_batch(self, placements, device=None) -> np.ndarray:
        """[B, F] float64 feature matrix of a stacked [B, N] candidate batch,
        computed on ``device`` (``None`` = the CUDA card).

        All accumulations are int64 and the features are exact integers, so
        the matrix is bit-identical on every device and to the reference's.
        """
        placements = np.asarray(placements, dtype=np.int32)
        if placements.ndim == 1:
            placements = placements[None]
        n = self.w_node.shape[0]
        if placements.shape[-1] != n:
            raise ValueError(
                f"placements are [B, {placements.shape[-1]}] but this "
                f"extractor was built for a {n}-node graph on a "
                f"{self.nx}x{self.ny} grid")
        if placements.size and (placements.min() < 0
                                or placements.max() >= self.num_pes):
            raise ValueError(
                f"placement references PEs outside the {self.nx}x{self.ny} "
                f"grid")
        dev = resolve_device(device)
        nx, ny, P = self.nx, self.ny, self.num_pes

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

        pe = t(placements)
        src, dst = t(self.src), t(self.dst)
        w_edge, c_unit, e_unit = t(self.w_edge), t(self.c_unit), t(self.e_unit)
        ps, pd = pe[:, src], pe[:, dst]
        sx, sy = ps // ny, ps % ny
        dx, dy = pd // ny, pd % ny
        hx = (dx - sx) % nx
        hy = (dy - sy) % ny
        hops = hx + hy
        remote = (hops > 0).to(torch.int64)

        t_w = (w_edge * hops).sum(-1)
        t_u = (e_unit * hops).sum(-1)
        t_c = (c_unit * hops).sum(-1)
        loads = _scatter(pe, t(self.w_node), P)
        counts = _scatter(pe, t(self.n_unit), P)
        inject = _scatter(ps, e_unit * remote, P)
        eject = _scatter(pd, e_unit * remote, P)
        # Ring loads: east hops run on the source row (X-ring sy), south
        # hops on the destination column (Y-ring dx) — dimension order.
        ring_x = _scatter(sy, w_edge * hx, ny)
        ring_y = _scatter(dx, w_edge * hy, nx)
        # [B, DEPTH_BUCKETS, P] weighted load per (wavefront level, PE).
        B, N = pe.shape
        lvl = _scatter(pe.unsqueeze(1).expand(B, DEPTH_BUCKETS, N),
                       t(self.w_bucket).T, P)
        out = assemble_features(t_w, t_u, t_c, loads, counts, inject,
                                eject, ring_x, ring_y, lvl)
        return out.cpu().numpy().astype(np.float64)


def features_from_tables(
    nx: int,
    ny: int,
    src: np.ndarray,
    dst: np.ndarray,
    w_edge: np.ndarray,
    w_node: np.ndarray,
    *,
    c_unit: np.ndarray | None = None,
    e_unit: np.ndarray | None = None,
    n_unit: np.ndarray | None = None,
    w_bucket: np.ndarray | None = None,
    depth: np.ndarray | None = None,
) -> FeatureExtractor:
    """Build an extractor directly from flat integer scoring tables.

    Defaults reproduce the fine-level (per-graph-node) semantics: unit
    multiplicities of 1, ``c_unit`` from the top-weight-class rule, and a
    one-hot ``w_bucket`` from ``depth`` (ASAP levels; all-zero when absent).
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w_edge = np.asarray(w_edge, dtype=np.int32)
    w_node = np.asarray(w_node, dtype=np.int32)
    n = w_node.shape[0]
    if c_unit is None:
        # "critical chain": edges carrying the top integer weight class.
        c_unit = (w_edge >= int(w_edge.max(initial=1))).astype(np.int32)
    if e_unit is None:
        e_unit = np.ones_like(w_edge)
    if n_unit is None:
        n_unit = np.ones_like(w_node)
    if w_bucket is None:
        if depth is None:
            depth = np.zeros(n, dtype=np.int64)
        depth = np.asarray(depth, dtype=np.int64)
        top = max(1, int(depth.max(initial=0)) + 1)
        bucket = (depth * DEPTH_BUCKETS // top).astype(np.int64)
        w_bucket = np.zeros((n, DEPTH_BUCKETS), dtype=np.int32)
        w_bucket[np.arange(n), bucket] = w_node
    w_bucket = np.asarray(w_bucket, dtype=np.int32)
    if w_bucket.shape != (n, DEPTH_BUCKETS):
        raise ValueError(
            f"w_bucket must be [{n}, {DEPTH_BUCKETS}], got {w_bucket.shape}")
    return FeatureExtractor(
        nx=nx, ny=ny, src=src, dst=dst, w_edge=w_edge, w_node=w_node,
        c_unit=np.asarray(c_unit, dtype=np.int32),
        e_unit=np.asarray(e_unit, dtype=np.int32),
        n_unit=np.asarray(n_unit, dtype=np.int32),
        w_bucket=w_bucket,
    )


def build_features(
    g: DataflowGraph,
    nx: int,
    ny: int,
    *,
    metric: str = "height",
    crit_scale: int = 3,
) -> FeatureExtractor:
    """Precompute the static feature tables for ``g`` on an ``nx x ny`` grid."""
    src, dst, w_edge, w_node = edge_tables(g, metric=metric,
                                           crit_scale=crit_scale)
    return features_from_tables(nx, ny, src, dst, w_edge, w_node,
                                depth=asap_levels(g))


def coarsen_extractor(ex: FeatureExtractor,
                      clusters: np.ndarray) -> FeatureExtractor:
    """Quotient-graph extractor whose features are EXACTLY the fine ones.

    Aggregates the fine tables over a ``[N] node -> cluster`` map: parallel
    inter-cluster edges sum their weights and unit multiplicities, cluster
    weights/units/bucket rows are member sums, and intra-cluster edges are
    dropped (their hops are 0 wherever the cluster lands, so every feature
    term they touch is 0 anyway). For any cluster placement ``cpe``::

        coarsen_extractor(ex, clusters).features_batch(cpe)
            == ex.features_batch(cpe[clusters])        # bit-exact

    Quotient edges are ordered by ``(src_cluster * C + dst_cluster)`` —
    identical to :func:`repro_torch.place.coarsen.quotient_tables`, so a
    guide built from this extractor shares the coarse annealer's incidence
    layout.
    """
    clusters = np.asarray(clusters, dtype=np.int64)
    n = ex.num_items
    if clusters.shape != (n,):
        raise ValueError(f"clusters must be [{n}] item->cluster, "
                         f"got {clusters.shape}")
    c = int(clusters.max(initial=-1)) + 1
    csrc, cdst = clusters[ex.src], clusters[ex.dst]
    cross = csrc != cdst
    pair = csrc[cross] * c + cdst[cross]
    uniq, inv = np.unique(pair, return_inverse=True)

    def agg_edge(v):
        out = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(out, inv, np.asarray(v, np.int64)[cross])
        return out.astype(np.int32)

    def agg_node(v):
        out = np.zeros(c, dtype=np.int64)
        np.add.at(out, clusters, np.asarray(v, np.int64))
        return out.astype(np.int32)

    w_bucket = np.zeros((c, DEPTH_BUCKETS), dtype=np.int64)
    np.add.at(w_bucket, clusters, ex.w_bucket.astype(np.int64))
    return FeatureExtractor(
        nx=ex.nx, ny=ex.ny,
        src=(uniq // c).astype(np.int32), dst=(uniq % c).astype(np.int32),
        w_edge=agg_edge(ex.w_edge),
        w_node=agg_node(ex.w_node),
        c_unit=agg_edge(ex.c_unit),
        e_unit=agg_edge(ex.e_unit),
        n_unit=agg_node(ex.n_unit),
        w_bucket=w_bucket.astype(np.int32),
    )
