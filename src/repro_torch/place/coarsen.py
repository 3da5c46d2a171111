"""Multilevel coarsen -> anneal -> refine placement (fig1-full scale), as in
the reference package.

The annealer moves one node per proposal, so a meaningful improvement on a
~470K-node graph needs a proposal budget that grows with N — intractable as
a direct search. The multilevel pipeline makes it tractable the way
large-graph partitioners do:

  1. **Coarsen** (:func:`cluster_nodes`): criticality-aware greedy heavy-edge
     clustering collapses the graph ~16-64x. Edges are visited in decreasing
     criticality weight (ties broken by edge id — fully deterministic), and
     endpoints are merged under a cluster-size cap, so critical chains — the
     latency-bound traffic — fold *inside* clusters first and become free
     local deliveries no matter where the cluster lands.
  2. **Anneal coarse** (:func:`repro_torch.place.anneal.anneal_tables`): the
     existing batched parallel-tempering placer runs unchanged on the cluster
     quotient graph — every proposal now moves a whole cluster, so the same
     proposal budget covers ~ratio x more of the search space.
  3. **Uncoarsen + refine**: the cluster placement projects back to nodes
     (``node_pe = cluster_pe[clusters]``) and an optional bounded fine-grained
     anneal polishes single-node details from that warm start.

Determinism: clustering is host-side numpy with stable sorts and integer
keys; both anneal levels are the bit-deterministic annealer (the CUDA kernel
on the card, its plain version on the CPU). For a fixed config the whole
pipeline equals the reference's bit for bit. With identity clusters
(``clusters=np.arange(N)``) the quotient tables carry exactly the original
edge weights, so the coarse anneal IS the plain annealer, bit for bit.
With ``guide=`` both levels run the surrogate-guided search: the coarse
phase with ``guide.coarsen(clusters)`` (quotient features equal the
projected fine features exactly), the refinement with the fine guide.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import DataflowGraph
from .anneal import PlacementResult, anneal_placement, anneal_tables
from .cost import build_cost_model, edge_tables
from .spec import AnnealConfig


@dataclasses.dataclass(frozen=True)
class MultilevelResult:
    """Final fine placement plus per-level diagnostics."""

    node_pe: np.ndarray            # [N] int32 node -> PE (after refinement)
    clusters: np.ndarray           # [N] int32 node -> cluster id
    num_clusters: int
    coarse: PlacementResult        # cluster-level anneal result
    cost: int                      # fine-level integer cost of node_pe
    projected_cost: int            # fine cost right after uncoarsening
    refined: PlacementResult | None  # fine-level refinement pass (or None)

    @property
    def refine_improvement(self) -> float:
        return 1.0 - self.cost / max(1, self.projected_cost)


def cluster_nodes(
    g: DataflowGraph,
    ratio: int = 32,
    *,
    metric: str = "height",
    crit_scale: int = 3,
) -> np.ndarray:
    """[N] int32 node -> cluster ids, ~``ratio`` nodes per cluster.

    Greedy heavy-edge agglomeration under a size cap: edges are processed in
    decreasing criticality weight (edge-id tiebreak, stable — deterministic),
    and the two endpoint clusters merge whenever the union stays within
    ``ratio`` nodes. Critical chains therefore collapse first, which is the
    criticality-aware part: the quotient graph keeps latency-bound edges
    internal. Cluster ids are compacted to 0..C-1 in first-node order.
    """
    if ratio < 1:
        raise ValueError(f"coarsen ratio must be >= 1, got {ratio}")
    n = g.num_nodes
    parent = np.arange(n, dtype=np.int64)
    size = np.ones(n, dtype=np.int64)

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:   # path compression
            parent[v], v = root, parent[v]
        return root

    if ratio > 1:
        src, dst, w_edge, _ = edge_tables(g, metric=metric,
                                          crit_scale=crit_scale)
        order = np.lexsort((np.arange(len(w_edge)), -w_edge.astype(np.int64)))
        for e in order:
            a, b = find(int(src[e])), find(int(dst[e]))
            if a != b and size[a] + size[b] <= ratio:
                if size[a] < size[b]:   # union by size
                    a, b = b, a
                parent[b] = a
                size[a] += size[b]

    roots = np.fromiter((find(v) for v in range(n)), dtype=np.int64, count=n)
    # Compact to dense ids in order of first appearance (node-id order).
    _, first_idx, compact = np.unique(roots, return_index=True,
                                      return_inverse=True)
    remap = np.argsort(np.argsort(first_idx, kind="stable"), kind="stable")
    return remap[compact].astype(np.int32)


def quotient_tables(
    g: DataflowGraph,
    clusters: np.ndarray,
    *,
    metric: str = "height",
    crit_scale: int = 3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-level ``(src, dst, w_edge, w_node)`` quotient tables.

    Parallel inter-cluster edges aggregate their integer weights; cluster
    weights are the sums of member node weights; intra-cluster edges vanish
    (their hops are 0 wherever the cluster lands). With identity clusters the
    tables are cost-equivalent to the fine graph's — every weight sum is
    preserved — which is what makes the identity-coarsened anneal bit-exact.
    """
    src, dst, w_edge, w_node = edge_tables(g, metric=metric,
                                           crit_scale=crit_scale)
    clusters = np.asarray(clusters, dtype=np.int64)
    c = int(clusters.max(initial=-1)) + 1
    csrc, cdst = clusters[src], clusters[dst]
    cross = csrc != cdst
    csrc, cdst, w = csrc[cross], cdst[cross], w_edge[cross].astype(np.int64)
    # Aggregate parallel edges: sum weights per (src, dst) cluster pair.
    pair = csrc * c + cdst
    uniq, inv = np.unique(pair, return_inverse=True)
    w_agg = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(w_agg, inv, w)
    cw = np.zeros(c, dtype=np.int64)
    np.add.at(cw, clusters, w_node.astype(np.int64))
    return ((uniq // c).astype(np.int32), (uniq % c).astype(np.int32),
            w_agg.astype(np.int32), cw.astype(np.int32))


def default_refine(acfg: AnnealConfig) -> AnnealConfig:
    """Bounded default polish: a fraction of the coarse budget spent on
    single-node moves from the projected warm start."""
    return dataclasses.replace(acfg, replicas=min(4, acfg.replicas),
                               rounds=max(1, acfg.rounds // 4))


def multilevel_anneal(
    g: DataflowGraph,
    nx: int,
    ny: int,
    acfg: AnnealConfig | None = None,
    *,
    ratio: int = 32,
    refine: AnnealConfig | str | None = "auto",
    clusters: np.ndarray | None = None,
    metric: str = "height",
    guide=None,
    guide_every: int = 1,
    guide_margin: float = 0.0,
    device=None,
) -> MultilevelResult:
    """Coarsen ``g`` ~``ratio``x, anneal cluster moves, project back, refine.

    ``acfg`` budgets the *coarse* anneal (cluster-level moves); ``refine``
    budgets a bounded fine-grained anneal warm-started from the projected
    placement — ``"auto"`` (the default, same as an unset
    ``PlacementSpec.refine``) derives :func:`default_refine` from ``acfg``,
    an explicit ``None`` skips refinement entirely (the projected placement
    is returned as-is). ``clusters`` overrides the clustering (e.g.
    ``np.arange(N)`` degenerates to the plain annealer, bit-exactly). Both
    anneals run on ``device`` (``None`` = the CUDA card). ``guide`` (a
    fitted :class:`~repro_torch.surrogate.model.SurrogateModel` or a
    :class:`~repro_torch.surrogate.delta.Guide` for ``g`` on this grid)
    guides both levels.
    """
    acfg = acfg or AnnealConfig()
    if isinstance(refine, str):
        if refine != "auto":
            raise ValueError(f"refine must be an AnnealConfig, None, or "
                             f"'auto'; got {refine!r}")
        refine = default_refine(acfg)
    if clusters is None:
        clusters = cluster_nodes(g, ratio, metric=metric,
                                 crit_scale=acfg.crit_scale)
    clusters = np.asarray(clusters, dtype=np.int32)
    if clusters.shape != (g.num_nodes,):
        raise ValueError(
            f"clusters must be [{g.num_nodes}] node->cluster, "
            f"got {clusters.shape}")
    csrc, cdst, cw_edge, cw_node = quotient_tables(
        g, clusters, metric=metric, crit_scale=acfg.crit_scale)
    c = int(cw_node.shape[0])

    coarse_guide = None
    if guide is not None:
        from ..surrogate.delta import Guide, build_guide

        if not isinstance(guide, Guide):
            guide = build_guide(guide)
        coarse_guide = guide.coarsen(clusters)
    coarse = anneal_tables(c, nx, ny, csrc, cdst, cw_edge, cw_node, acfg,
                           guide=coarse_guide, guide_every=guide_every,
                           guide_margin=guide_margin, device=device)
    node_pe = coarse.node_pe[clusters].astype(np.int32)

    model = build_cost_model(g, nx, ny, metric=metric,
                             crit_scale=acfg.crit_scale,
                             pressure_weight=acfg.pressure_weight,
                             device="cpu")
    projected_cost = int(model.cost(node_pe))

    refined = None
    if refine is not None:
        refined = anneal_placement(g, nx, ny, refine, metric=metric,
                                   init=node_pe, model=model, guide=guide,
                                   guide_every=guide_every,
                                   guide_margin=guide_margin, device=device)
        node_pe = refined.node_pe

    return MultilevelResult(
        node_pe=node_pe,
        clusters=clusters,
        num_clusters=c,
        coarse=coarse,
        cost=int(refined.cost) if refined is not None else projected_cost,
        projected_cost=projected_cost,
        refined=refined,
    )
