"""Node -> PE placement and per-PE local graph memory construction.

This reproduces the paper's memory organization: each PE holds a *local graph
memory* of node records, laid out in **decreasing criticality order** so the
leading-one detector's first hit is the most critical ready node (§II-B).

The packed image (:class:`GraphMemory`) is the only thing the simulator sees.
It is plain numpy, byte-equal to the reference package's packing of the same
graph; :func:`repro_torch.core.overlay.device_graph` moves it onto a torch
device.
:func:`rdy_flag_overhead`, :func:`fifo_worst_case_words` and
:func:`capacity_elements` are the paper's BRAM cost model (Table 1).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..place.slots import assign_slots
from .criticality import criticality as _criticality
from .graph import DataflowGraph

FLAGS_PER_WORD = 32  # paper: 32 of the 40 BRAM bits hold RDY flags


@dataclasses.dataclass(frozen=True)
class GraphMemory:
    """Per-PE packed view of a placed dataflow graph.

    All arrays are numpy; the overlay converts to torch. P = nx*ny PEs.

    Node records, [P, lmax] (padded with valid=False):
      opcode, fanin, init_value, fo_base (into the per-PE edge arrays),
      fo_count, valid.
    Edge records, [P, emax]:
      e_dst_pe, e_dst_slot (local slot at destination PE), e_dst_opidx.
    node_pe/node_slot: [N] global -> (pe, slot) map (for reading results back).
    """

    nx: int
    ny: int
    lmax: int
    emax: int
    words: int
    opcode: np.ndarray
    fanin: np.ndarray
    init_value: np.ndarray
    fo_base: np.ndarray
    fo_count: np.ndarray
    valid: np.ndarray
    e_dst_pe: np.ndarray
    e_dst_slot: np.ndarray
    e_dst_opidx: np.ndarray
    node_pe: np.ndarray
    node_slot: np.ndarray
    local_counts: np.ndarray

    @property
    def num_pes(self) -> int:
        return self.nx * self.ny

    @property
    def num_nodes(self) -> int:
        return int(self.node_pe.shape[0])


def place_nodes(
    g: DataflowGraph,
    num_pes: int,
    strategy: str = "round_robin",
    seed: int = 0,
    cluster: int = 16,
) -> np.ndarray:
    """[N] node -> PE assignment.

    ``clustered``: consecutive node-id segments (which follow the generator's
    block structure) are confined to small PE clusters laid out as square
    tiles of the grid, so most dataflow edges travel ~sqrt(cluster) NoC hops
    instead of ~grid-diameter.
    """
    n = g.num_nodes
    if strategy == "round_robin":
        return (np.arange(n) % num_pes).astype(np.int32)
    if strategy == "blocked":
        per = math.ceil(n / num_pes)
        return (np.arange(n) // per).astype(np.int32)
    if strategy == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, num_pes, size=n).astype(np.int32)
    if strategy == "clustered":
        return place_nodes_clustered_ids(n, num_pes, cluster)
    if strategy == "bulk_clustered":
        # Bulk traffic is bandwidth-bound -> confine it to small PE tiles
        # (short hops); the critical chain is latency- and injection-bound ->
        # keep it round-robin across the whole grid.
        c = _criticality(g, "height")
        n_chain = max(num_pes, int(n * 0.05))
        order = np.argsort(-c, kind="stable")
        chain, bulk = order[:n_chain], order[n_chain:]
        pe = np.empty(n, dtype=np.int32)
        pe[chain] = (np.arange(n_chain) % num_pes).astype(np.int32)
        pe[bulk] = place_nodes_clustered_ids(len(bulk), num_pes, cluster)
        return pe
    if strategy == "critical_chain":
        # The critical chain is latency-bound, the bulk bandwidth-bound.
        # Successive high-criticality nodes share a PE (chain links become
        # 1-cycle local deliveries), strided across the grid; the bulk is
        # spread round-robin.
        c = _criticality(g, "height")
        n_chain = max(num_pes, int(n * 0.05))
        order = np.argsort(-c, kind="stable")
        chain = order[:n_chain]
        pe = np.empty(n, dtype=np.int32)
        chunk = max(1, math.ceil(n_chain / num_pes))
        stride = 37 % num_pes or 1              # coprime stride spreads chunks
        pe[chain] = ((np.arange(n_chain) // chunk) * stride % num_pes).astype(np.int32)
        bulk = order[n_chain:]
        pe[bulk] = (np.arange(n - n_chain) % num_pes).astype(np.int32)
        return pe
    raise ValueError(f"unknown placement strategy {strategy!r}")


def place_nodes_clustered_ids(n: int, num_pes: int, cluster: int = 16) -> np.ndarray:
    """Clustered-tile assignment for ``n`` consecutive ids (helper)."""
    ny = int(math.sqrt(num_pes))            # grid assumed square
    nx = num_pes // ny
    ts = max(1, int(math.sqrt(cluster)))    # tile side (4 for cluster=16)
    tiles_x, tiles_y = max(1, nx // ts), max(1, ny // ts)
    k = tiles_x * tiles_y                   # number of tile clusters
    seg = max(1, math.ceil(n / (4 * k)))    # ~4 segments per cluster
    ids = np.arange(n)
    cl = (ids // seg) % k
    w = ids % (ts * ts)
    cx, cy = cl // tiles_y, cl % tiles_y
    wx, wy = w // ts, w % ts
    return ((cx * ts + wx) * ny + (cy * ts + wy)).astype(np.int32)


def packed_shape(g: DataflowGraph, node_pe: np.ndarray,
                 num_pes: int) -> tuple[int, int]:
    """Pre-padding ``(lmax, emax)`` that :func:`build_graph_memory` packs for
    ``node_pe``: the deepest per-PE slot count and edge count."""
    node_pe = np.asarray(node_pe)
    counts = np.zeros(num_pes, dtype=np.int64)
    np.add.at(counts, node_pe, 1)
    ecounts = np.zeros(num_pes, dtype=np.int64)
    np.add.at(ecounts, node_pe, g.fanout_count().astype(np.int64))
    return int(counts.max(initial=1)), max(1, int(ecounts.max(initial=1)))


def build_graph_memory(
    g: DataflowGraph,
    nx: int,
    ny: int,
    *,
    placement: str | np.ndarray = "round_robin",
    metric: str = "height",
    criticality_order: bool = True,
    seed: int = 0,
    min_lmax: int = 0,
    min_emax: int = 0,
) -> GraphMemory:
    """Place ``g`` on an ``nx x ny`` PE grid and pack local memories.

    ``placement`` is a strategy name (see :func:`place_nodes`) or an explicit
    ``[N]`` node -> PE vector.

    ``criticality_order=True`` sorts each PE's local memory in decreasing
    criticality (the paper's static heuristic); ``False`` keeps node-id order
    (what a naive layout would do).

    ``min_lmax`` / ``min_emax`` pad the packed slot depth / per-PE edge
    capacity beyond what this placement needs. Padding slots are
    ``valid=False`` and padding edge words are never addressed, but the
    ``scan`` policy *models* its select latency as the RDY word count, so a
    deeper padded memory is a slower scanned memory under that policy.
    """
    num_pes = nx * ny
    n = g.num_nodes
    if isinstance(placement, np.ndarray):
        node_pe = placement.astype(np.int32)
        if node_pe.shape != (n,):
            raise ValueError(
                f"explicit placement must be [{n}] node->PE, got {node_pe.shape}")
        if n and (node_pe.min() < 0 or node_pe.max() >= num_pes):
            raise ValueError(
                f"placement references PEs outside the {nx}x{ny} grid")
    else:
        node_pe = place_nodes(g, num_pes, placement, seed)
    c = _criticality(g, metric) if criticality_order else -np.arange(n, dtype=np.int64)

    # Local slot assignment: per PE, decreasing criticality, node id tiebreak.
    node_slot, local_counts = assign_slots(node_pe, c, num_pes)

    lmax_nat, emax_nat = packed_shape(g, node_pe, num_pes)
    lmax = max(lmax_nat, int(min_lmax))
    words = max(1, math.ceil(lmax / FLAGS_PER_WORD))
    lmax_padded = words * FLAGS_PER_WORD

    def per_node(arr, fill, dtype):
        out = np.full((num_pes, lmax_padded), fill, dtype=dtype)
        out[node_pe, node_slot] = arr
        return out

    opcode = per_node(g.opcode, 0, np.int8)
    fanin = per_node(g.fanin_count(), 0, np.int8)
    init_value = per_node(g.initial_values, 0.0, np.float32)
    valid = np.zeros((num_pes, lmax_padded), dtype=bool)
    valid[node_pe, node_slot] = True

    # Per-PE edge arrays: edges grouped by (pe, slot-order of source node).
    fo_count = per_node(g.fanout_count(), 0, np.int32)
    fo_base = np.zeros((num_pes, lmax_padded), dtype=np.int32)
    emax = max(emax_nat, int(min_emax))

    e_dst_pe = np.zeros((num_pes, emax), dtype=np.int32)
    e_dst_slot = np.zeros((num_pes, emax), dtype=np.int32)
    e_dst_opidx = np.zeros((num_pes, emax), dtype=np.int8)

    # Sort nodes per PE by local slot; lay their fanout lists contiguously.
    slot_order = np.lexsort((node_slot, node_pe))
    cursor = np.zeros(num_pes, dtype=np.int64)
    ptr, dst, slt = g.fanout_ptr, g.fanout_dst, g.fanout_slot
    for v in slot_order:
        p = node_pe[v]
        lo, hi = ptr[v], ptr[v + 1]
        k = hi - lo
        base = cursor[p]
        fo_base[p, node_slot[v]] = base
        if k:
            d = dst[lo:hi]
            e_dst_pe[p, base:base + k] = node_pe[d]
            e_dst_slot[p, base:base + k] = node_slot[d]
            e_dst_opidx[p, base:base + k] = slt[lo:hi]
            cursor[p] = base + k

    return GraphMemory(
        nx=nx, ny=ny, lmax=lmax_padded, emax=emax, words=words,
        opcode=opcode, fanin=fanin, init_value=init_value,
        fo_base=fo_base, fo_count=fo_count, valid=valid,
        e_dst_pe=e_dst_pe, e_dst_slot=e_dst_slot, e_dst_opidx=e_dst_opidx,
        node_pe=node_pe, node_slot=node_slot, local_counts=local_counts,
    )


# ---------------------------------------------------------------------------
# Memory-cost model (paper §II-B and §III) — Table 1 of the paper.
# ---------------------------------------------------------------------------

M20K_BITS = 20 * 1024
BRAM_WORDS = 512          # 512 x 40b configuration
BRAM_WIDTH_BITS = 40
BRAMS_PER_PE = 8          # "our TDP design is composed of 8 BRAMs/processor"
NODE_RECORD_WORDS = 4     # opcode/meta + 2 operand slots + result
EDGE_RECORD_WORDS = 1     # dst node + operand slot pack into one 40b word


def rdy_flag_overhead() -> float:
    """Fraction of graph-memory words spent on RDY bit-flag vectors.

    Paper: per 512-word BRAM, 2 * ceil(512/32) = 32 words of flags (~6.25%).
    """
    per_bram = 2 * math.ceil(BRAM_WORDS / FLAGS_PER_WORD)
    return per_bram / BRAM_WORDS


def fifo_worst_case_words(local_words: int) -> int:
    """Deadlock-free FIFO depth: every addressable local word could hold a
    simultaneously-ready node, so depth == graph-memory word count."""
    return int(local_words)


def capacity_elements(num_pes: int, scheduler: str,
                      edge_per_node: float = 1.5) -> dict:
    """On-chip graph capacity (nodes + edges) under each scheduler.

    In-order (prior TDPs): FIFOs live in *dedicated* BRAMs (a hardware FIFO
    cannot share ports with graph memory) and deadlock-freedom needs TWO
    worst-case queues (compute-ready ids + fanout-pending ids), each as deep
    as the addressable local node space. Solving g + 2g <= 8 gives 2 graph
    BRAMs + 6 FIFO BRAMs per PE — which is what pins the paper's in-order
    256-PE overlay at ~100K nodes+edges.

    OoO (this paper): no FIFOs; 2 x ceil(512/32) = 32 flag words per BRAM
    (~6.25%), everything else stores the graph -> ~5x capacity.
    """
    if scheduler == "inorder":
        graph_brams = BRAMS_PER_PE // (1 + 2)  # g + 2g <= 8 -> g = 2
        words = graph_brams * BRAM_WORDS * num_pes
        fifo_words = (BRAMS_PER_PE - graph_brams) * BRAM_WORDS * num_pes
    elif scheduler == "ooo":
        words = int(BRAMS_PER_PE * BRAM_WORDS * (1 - rdy_flag_overhead())) * num_pes
        fifo_words = 0
    else:
        raise ValueError(scheduler)
    # words = N * NODE_RECORD_WORDS + E * EDGE_RECORD_WORDS, E = r*N
    n = words / (NODE_RECORD_WORDS + edge_per_node * EDGE_RECORD_WORDS)
    return {
        "graph_words": int(words),
        "fifo_words": int(fifo_words),
        "nodes": int(n),
        "elements": int(n * (1 + edge_per_node)),
    }
