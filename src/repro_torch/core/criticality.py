"""Static one-time criticality labeling (paper §II-B).

The paper runs "a one-time software criticality evaluation on the application
dataflow graph" and stores nodes in each PE's local memory in *decreasing*
criticality order, so that the hierarchical leading-one detector implicitly
picks the most critical ready node.

We provide three metrics:
  * ``height``  — longest path (in nodes) from the node to any sink. This is
    the classic critical-path criticality: nodes on the critical path have
    maximal height at their depth. (default; what the paper's heuristic needs)
  * ``slack``   — ALAP(v) - ASAP(v); criticality = -slack (0-slack nodes are
    on the critical path).
  * ``fanout_height`` — height weighted by downstream fanout mass, a tiebreak
    that prefers nodes unlocking more parallelism.
"""
from __future__ import annotations

import numpy as np

from .graph import DataflowGraph


def asap_levels(g: DataflowGraph) -> np.ndarray:
    """[N] earliest firing level (INPUTs at 0)."""
    order = g.topological_order()
    lvl = np.zeros(g.num_nodes, dtype=np.int64)
    ptr, dst = g.fanout_ptr, g.fanout_dst
    for v in order:
        for u in dst[ptr[v]:ptr[v + 1]]:
            lvl[u] = max(lvl[u], lvl[v] + 1)
    return lvl


def height(g: DataflowGraph) -> np.ndarray:
    """[N] longest path to a sink, in edges (sinks have height 0)."""
    order = g.topological_order()
    h = np.zeros(g.num_nodes, dtype=np.int64)
    ptr, dst = g.fanout_ptr, g.fanout_dst
    for v in order[::-1]:
        lo, hi = ptr[v], ptr[v + 1]
        if hi > lo:
            h[v] = 1 + h[dst[lo:hi]].max()
    return h


def slack(g: DataflowGraph) -> np.ndarray:
    """[N] ALAP - ASAP. Zero slack == critical path."""
    asap = asap_levels(g)
    h = height(g)
    depth = int((asap + h).max()) if g.num_nodes else 0
    alap = depth - h
    return alap - asap


def fanout_height(g: DataflowGraph) -> np.ndarray:
    """Height with a fractional fanout tiebreak in [0, 1)."""
    h = height(g).astype(np.float64)
    fo = g.fanout_count().astype(np.float64)
    return h + fo / (fo.max() + 1.0)


_METRICS = {
    "height": height,
    "neg_slack": lambda g: -slack(g),
    "fanout_height": fanout_height,
}


def criticality(g: DataflowGraph, metric: str = "height") -> np.ndarray:
    """[N] criticality labels; larger == more critical."""
    try:
        fn = _METRICS[metric]
    except KeyError:
        raise ValueError(f"unknown criticality metric {metric!r}; have {sorted(_METRICS)}")
    return np.asarray(fn(g))
