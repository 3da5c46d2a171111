"""Dataflow-graph workload generators (numpy, host-side).

The paper evaluates on "dataflow graphs extracted from sparse matrix
factorization kernels". :func:`arrow_lu_graph` extracts that structure: the
fine-grained operator DAG of a right-looking sparse LU factorization
(Doolittle, no pivoting) with symbolic fill-in, where
  L[i,k]   = A[i,k] / U[k,k]                      (DIV node)
  A[i,j]  -= L[i,k] * U[k,j]                      (MUL + SUB nodes)
:func:`layered_dag` is a random layered DAG for small tests.

Both draw from numpy's ``default_rng`` exactly as the reference package's
generators do, so the same arguments give byte-equal graphs.
"""
from __future__ import annotations

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
