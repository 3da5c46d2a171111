"""Dataflow-graph workload generators (numpy, host-side).

The paper evaluates on "dataflow graphs extracted from sparse matrix
factorization kernels". :func:`arrow_lu_graph` extracts that structure: the
fine-grained operator DAG of a right-looking sparse LU factorization
(Doolittle, no pivoting) with symbolic fill-in, where
  L[i,k]   = A[i,k] / U[k,k]                      (DIV node)
  A[i,j]  -= L[i,k] * U[k,j]                      (MUL + SUB nodes)
:func:`sparse_lu_graph`, :func:`banded_lu_graph` and
:func:`elimination_tree_graph` are other factorization structures;
:func:`layered_dag`, :func:`reduction_tree`, :func:`chain` and
:func:`random_dag` are small DAGs for tests. :func:`fig1_full` is the
paper-scale sparse-LU DAG. :func:`service_stream` is the placement
service's replayed stream; :func:`warm_cache` (``python -m
repro_torch.core.workloads [name ...]``) fills the graph cache.

Every generator draws from numpy's ``default_rng`` exactly as the reference
package's does, so the same arguments give byte-equal graphs. The on-disk
cache (:func:`cached_graph`) keeps the reference's file format and default
directory, so a graph saved by either package loads in the other.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .graph import OP_ADD, OP_DIV, OP_MUL, OP_SUB, DataflowGraph, GraphBuilder


def _lu_eliminate(b: GraphBuilder, rows_map: list[dict[int, int]]) -> DataflowGraph:
    """Right-looking Doolittle elimination over a dict-of-rows pattern.

    ``rows_map[i]`` maps column -> node id of the current value of A[i, j].
    Fill-in is materialized as SUB from a zero input (token semantics).
    """
    n = len(rows_map)
    for k in range(n):
        pivot = rows_map[k][k]
        for i in range(k + 1, n):
            if k not in rows_map[i]:
                continue
            lik = b.op(OP_DIV, rows_map[i][k], pivot)  # L[i,k]
            del rows_map[i][k]
            for j, ukj in list(rows_map[k].items()):
                if j <= k:
                    continue
                prod = b.op(OP_MUL, lik, ukj)
                if j in rows_map[i]:
                    rows_map[i][j] = b.op(OP_SUB, rows_map[i][j], prod)
                else:  # fill-in: 0 - prod == SUB from a zero input
                    zero = b.input(0.0)
                    rows_map[i][j] = b.op(OP_SUB, zero, prod)
    return b.build()


def _pattern_inputs(b: GraphBuilder, n: int, keep, rng) -> list[dict[int, int]]:
    rows_map: list[dict[int, int]] = []
    for i in range(n):
        row: dict[int, int] = {}
        for j in range(n):
            if i == j or keep(i, j):
                val = rng.uniform(0.5, 2.0) * (n if i == j else 1.0)
                row[j] = b.input(val)
        rows_map.append(row)
    return rows_map


def sparse_lu_graph(n: int, density: float = 0.05, seed: int = 0) -> DataflowGraph:
    """Operator DAG of sparse LU factorization of a random n x n matrix.

    Node/edge count grows roughly with fill-in; use :func:`lu_size_for_nodes`
    to pick ``n`` for a target node budget.
    """
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    rows_map = _pattern_inputs(b, n, lambda i, j: rng.random() < density, rng)
    return _lu_eliminate(b, rows_map)


def arrow_lu_graph(blocks: int, block_size: int, border: int, seed: int = 0) -> DataflowGraph:
    """LU DAG of a bordered block-diagonal ("arrow") matrix.

    ``blocks`` independent dense diagonal blocks (bulk parallelism that fills
    every PE's ready queue) coupled by a dense border whose update chains run
    through *every* block (the critical path). In-order FCFS buries the
    border chain behind block bulk; criticality-ordered OoO keeps it moving:
    the workload family behind the paper's Fig. 1 regime.
    """
    rng = np.random.default_rng(seed)
    n = blocks * block_size + border

    def keep(i, j):
        bi, bj = i // block_size, j // block_size
        in_border = i >= blocks * block_size or j >= blocks * block_size
        return in_border or bi == bj

    b = GraphBuilder()
    rows_map = _pattern_inputs(b, n, keep, rng)
    return _lu_eliminate(b, rows_map)


def banded_lu_graph(rows: int, band: int, seed: int = 0, inband_density: float = 1.0) -> DataflowGraph:
    """LU factorization DAG of a banded matrix (e.g. a discretized PDE /
    circuit matrix after ordering). Structured sparsity keeps the available
    parallelism bounded (~band^2) while the critical path grows with ``rows``
    — the regime where the paper's criticality-aware scheduling pays off."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()

    def keep(i, j):
        return abs(i - j) <= band and (inband_density >= 1.0 or rng.random() < inband_density)

    rows_map = _pattern_inputs(b, rows, keep, rng)
    return _lu_eliminate(b, rows_map)


def elimination_tree_graph(
    depth: int, chain_len: int = 16, leaf_width: int = 32, seed: int = 0
) -> DataflowGraph:
    """Supernodal elimination-tree DAG (sparse Cholesky/LU structure).

    ``2**depth`` leaves of wide independent work (the bushy bottom of a
    nested-dissection elimination tree) feed binary merges, each followed by
    a sequential update chain of length ``chain_len`` (the separator/
    supernode factorization). Root-ward chains are the critical path; leaf
    bulk floods every PE's ready queue — the mixed regime where FCFS hurts.
    """
    rng = np.random.default_rng(seed)
    b = GraphBuilder()

    def leaf() -> int:
        vals = [b.input(rng.uniform(0.5, 2.0)) for _ in range(leaf_width)]
        while len(vals) > 1:
            nxt = [b.op(OP_ADD, vals[2 * i], vals[2 * i + 1]) for i in range(len(vals) // 2)]
            if len(vals) % 2:
                nxt.append(vals[-1])
            vals = nxt
        return vals[0]

    def rec(d: int) -> int:
        if d == 0:
            return leaf()
        a = rec(d - 1)
        c = rec(d - 1)
        v = b.op(OP_ADD, a, c)
        for _ in range(chain_len):
            v = b.op(OP_MUL, v, b.input(rng.uniform(0.9, 1.1)))
        return v

    rec(depth)
    return b.build()


def lu_size_for_nodes(target_nodes: int) -> tuple[int, float]:
    """Heuristic (n, density) whose LU DAG lands near ``target_nodes``.

    Random-pattern sparse LU fills in almost densely during elimination, so
    the operator count tracks the *dense*-LU flop count: nodes ~= 1.15 *
    n^3 / 3, measured over this table's density ramp (the old
    ``(n d)^2 n / 3`` input-pattern estimate undershot ~30x at scale).
    Densities ramp down with ``n`` so the *input* pattern stays sparse —
    the structure of the paper's workloads — while fill-in does the growing.
    """
    for n, d in [(16, 0.25), (24, 0.25), (32, 0.25), (48, 0.2), (64, 0.15),
                 (80, 0.12), (96, 0.1), (108, 0.1), (128, 0.09), (160, 0.08),
                 (192, 0.07)]:
        if 1.15 * n ** 3 / 3 >= target_nodes:
            return n, d
    return 256, 0.06


# ---------------------------------------------------------------------------
# On-disk graph cache: the big LU DAGs are built by Python elimination loops
# (seconds to minutes at fig1-full scale) but are pure functions of their
# seeds, so they are memoized as npz files under experiments/.
# ---------------------------------------------------------------------------

def graph_cache_dir() -> str:
    """Cache root: ``$REPRO_GRAPH_CACHE`` or ``./experiments/graph_cache``."""
    return os.environ.get(
        "REPRO_GRAPH_CACHE",
        os.path.join(os.getcwd(), "experiments", "graph_cache"))


def save_graph(g: DataflowGraph, path: str) -> None:
    import tempfile

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # Unique tmp + atomic rename: concurrent cold-starting bench runs never
    # interleave writes or publish a torso (last replace wins, both valid).
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f, opcode=g.opcode, fanout_ptr=g.fanout_ptr,
                fanout_dst=g.fanout_dst, fanout_slot=g.fanout_slot,
                initial_values=g.initial_values)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_graph(path: str) -> DataflowGraph:
    with np.load(path) as z:
        return DataflowGraph(
            opcode=z["opcode"], fanout_ptr=z["fanout_ptr"],
            fanout_dst=z["fanout_dst"], fanout_slot=z["fanout_slot"],
            initial_values=z["initial_values"])


def cached_graph(name: str, builder: Callable[[], DataflowGraph], *,
                 cache_dir: str | None = None) -> DataflowGraph:
    """Build-once graph memoization: load ``<cache_dir>/<name>.npz`` if it
    exists, else run ``builder`` and persist its result there.

    ``name`` must encode every builder parameter (sizes, seeds) — the cache
    trusts it blindly. Delete the file (or point ``$REPRO_GRAPH_CACHE``
    elsewhere) to force a rebuild.
    """
    path = os.path.join(cache_dir or graph_cache_dir(), f"{name}.npz")
    if os.path.exists(path):
        return load_graph(path)
    g = builder()
    save_graph(g, path)
    return g


def fig1_full(target_nodes: int = 470_000, seed: int = 0, *,
              cache: bool = True, cache_dir: str | None = None) -> DataflowGraph:
    """The paper's fig1-full-scale workload: a sparse-LU DAG near ~470K nodes
    (502,447 at the default target).

    ``(n, density)`` come from :func:`lu_size_for_nodes`, so the constructor
    is calibrated rather than guessed; the result is cached on disk under
    the reference's name (``fig1_full_lu_n<n>_d<density>_seed<seed>``), so a
    graph either package built loads in the other. The elimination loop
    takes minutes at this scale.
    """
    n, d = lu_size_for_nodes(target_nodes)
    name = f"fig1_full_lu_n{n}_d{d}_seed{seed}"
    builder = lambda: sparse_lu_graph(n, d, seed=seed)
    if not cache:
        return builder()
    return cached_graph(name, builder, cache_dir=cache_dir)


#: The Fig. 1 graph the telemetry CLI simulates, under the reference's cache
#: name: ``arrow_lu_graph(4, 10, 8, seed=3)``, 15,072 nodes.
TELEMETRY_GRAPH = "arrow_b4_s10_w8_seed3"

#: Fig. 1-family graphs ``python -m repro_torch.kernels --smoke`` simulates,
#: under the reference's cache names; ``warm_cache(["megakernel_bench"])``
#: builds them ahead so the smoke never pays the elimination loop.
MEGAKERNEL_BENCH_GRAPHS = ("arrow_b4_s10_w8_seed3", "arrow_b8_s10_w8_seed3")


def service_stream(n_queries: int = 32, distinct: int = 8,
                   seed: int = 0) -> list:
    """Deterministic replayed graph stream for the placement service.

    ``distinct`` small Fig. 1-family arrow-LU graphs, each once up front,
    then ``n_queries - distinct`` repeats: a round-robin pass first (when
    the stream is long enough every distinct graph repeats at least once),
    the rest drawn from a fixed numpy PRNG, in the reference's order. 32
    queries over 8 graphs carry 75% repeats. Returns ``[(name,
    DataflowGraph)]``, the reference's names and graphs.
    """
    if not 1 <= distinct <= n_queries:
        raise ValueError(
            f"need 1 <= distinct <= n_queries, got {distinct}/{n_queries}")
    variants = []
    for blocks in (2, 3, 4, 5):
        for gseed in (1, 2):
            variants.append((f"svc_arrow_b{blocks}_s6_w4_seed{gseed}",
                             (blocks, 6, 4, gseed)))
    if distinct > len(variants):
        raise ValueError(f"at most {len(variants)} distinct stream graphs, "
                         f"got {distinct}")
    graphs = [(name, arrow_lu_graph(b, s, w, seed=sd))
              for name, (b, s, w, sd) in variants[:distinct]]
    rng = np.random.default_rng(seed)
    stream = list(graphs)
    n_repeats = n_queries - distinct
    stream += [graphs[i % distinct] for i in range(min(n_repeats, distinct))]
    for _ in range(n_repeats - distinct):
        stream.append(graphs[int(rng.integers(0, distinct))])
    return stream


def warm_cache(names: list[str] | None = None) -> dict[str, int]:
    """Build (or load) cacheable graphs into the graph cache.

    ``python -m repro_torch.core.workloads [name ...]``. Known names:
    ``fig1_full`` (the default), ``arrow_b{blocks}_s{size}_w{border}_seed
    {seed}`` and ``megakernel_bench`` (:data:`MEGAKERNEL_BENCH_GRAPHS`).
    Returns ``{name: num_nodes}``; an unknown name raises ``ValueError``.
    """
    names = names or ["fig1_full"]
    built: dict[str, int] = {}
    for name in names:
        if name == "fig1_full":
            built[name] = fig1_full().num_nodes
            continue
        if name == "megakernel_bench":
            built.update(warm_cache(list(MEGAKERNEL_BENCH_GRAPHS)))
            continue
        if name.startswith("arrow_"):
            parts = dict(
                (p[0], int(p[1:])) for p in name.split("_")[1:]
                if p[0] in "bsw" and p[1:].isdigit())
            seed = int(name.rsplit("seed", 1)[1]) if "seed" in name else 0
            if {"b", "s", "w"} <= parts.keys():
                g = cached_graph(name, lambda: arrow_lu_graph(
                    parts["b"], parts["s"], parts["w"], seed=seed))
                built[name] = g.num_nodes
                continue
        raise ValueError(f"don't know how to build cached graph {name!r}")
    return built


def layered_dag(
    num_layers: int,
    width: int,
    fanout: int = 2,
    seed: int = 0,
    skew: float = 0.0,
) -> DataflowGraph:
    """Random layered DAG: each non-input node consumes 2 values from earlier
    layers. ``skew`` > 0 concentrates edges on a critical "spine" so that
    criticality-aware scheduling has something to exploit."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    layers = [[b.input(rng.uniform(0.5, 2.0)) for _ in range(width)]]
    ops = np.array([OP_ADD, OP_SUB, OP_MUL], dtype=np.int64)
    for li in range(1, num_layers):
        prev = layers[-1]
        cur = []
        for wi in range(width):
            if skew > 0 and wi == 0:
                a = prev[0]  # spine: long dependence chain
            else:
                a = prev[rng.integers(len(prev))]
            src_layer = layers[rng.integers(max(0, li - fanout), li)]
            bb = src_layer[rng.integers(len(src_layer))]
            cur.append(b.op(int(ops[rng.integers(3)]), a, bb))
        layers.append(cur)
    # Reduce the last layer so the DAG has few sinks (like a solve result).
    frontier = layers[-1]
    while len(frontier) > 1:
        frontier = [
            b.op(OP_ADD, frontier[2 * i], frontier[2 * i + 1])
            for i in range(len(frontier) // 2)
        ] + ([frontier[-1]] if len(frontier) % 2 else [])
    return b.build()


def reduction_tree(leaves: int, seed: int = 0) -> DataflowGraph:
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    frontier = [b.input(rng.uniform(0.5, 2.0)) for _ in range(leaves)]
    while len(frontier) > 1:
        nxt = [
            b.op(OP_ADD, frontier[2 * i], frontier[2 * i + 1])
            for i in range(len(frontier) // 2)
        ]
        if len(frontier) % 2:
            nxt.append(frontier[-1])
        frontier = nxt
    return b.build()


def chain(length: int, seed: int = 0) -> DataflowGraph:
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    v = b.input(rng.uniform(0.5, 2.0))
    for _ in range(length):
        c = b.input(rng.uniform(0.5, 2.0))
        v = b.op(OP_ADD, v, c)
    return b.build()


def random_dag(num_nodes: int, seed: int = 0, input_frac: float = 0.2) -> DataflowGraph:
    """Unstructured random DAG for property tests (edges i -> j only if i < j)."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    ids: list[int] = []
    n_inputs = max(2, int(num_nodes * input_frac))
    ops = [OP_ADD, OP_SUB, OP_MUL, OP_DIV]
    for i in range(num_nodes):
        if i < n_inputs:
            ids.append(b.input(rng.uniform(0.5, 2.0)))
        else:
            a, c = rng.integers(0, i, size=2)
            ids.append(b.op(ops[rng.integers(4)], ids[a], ids[c]))
    return b.build()


if __name__ == "__main__":
    import sys

    for _name, _nodes in warm_cache(sys.argv[1:] or None).items():
        print(f"{_name}: {_nodes} nodes (cache: {graph_cache_dir()})")
