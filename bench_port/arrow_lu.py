"""Frozen copy of the arrow-LU dataflow-graph generator, the workload family
of the paper's Fig. 1.

Copied from ``src/repro_torch/core/workloads.py`` (``arrow_lu_graph``,
``_pattern_inputs``, ``_lu_eliminate``) and ``src/repro_torch/core/graph.py``
(``GraphBuilder.build``), so that later changes to the program cannot move
the yardstick. It is split in two:

* :func:`structure` is the DAG (opcodes, fanout CSR, operand slots) of the
  right-looking Doolittle elimination of a bordered block-diagonal matrix.
  The arrow pattern draws nothing at random, so the structure does not
  depend on any seed.
* :func:`input_values` draws the matrix entries from a seed, exactly as the
  original draws them: ``uniform(0.5, 2.0)`` in row-major order, times
  ``n`` on the diagonal; fill-in inputs are 0. With seed 3 the values are
  those of ``arrow_lu_graph(blocks, block_size, border, seed=3)``.

The timing of a dataflow graph does not depend on its values, so every seed
has the same cycle counts; the values change what the ALU computes.
"""
from __future__ import annotations

import numpy as np

OP_INPUT, OP_ADD, OP_SUB, OP_MUL, OP_DIV = 0, 1, 2, 3, 4


def structure(blocks: int, block_size: int, border: int) -> dict:
    """The arrow-LU DAG as numpy arrays: ``opcode`` [N] int8, ``fanout_ptr``
    [N+1] int64, ``fanout_dst`` [E] int64, ``fanout_slot`` [E] int8 (CSR by
    source, edges of a source in creation order), and ``entry_scale`` [N]
    float64: 0 for operator nodes and fill-in zeros, ``n`` for a diagonal
    entry, 1 for another matrix entry."""
    n = blocks * block_size + border
    opcode: list[int] = []
    scale: list[float] = []
    edges: list[tuple[int, int, int]] = []

    def new_input(s: float) -> int:
        opcode.append(OP_INPUT)
        scale.append(s)
        return len(opcode) - 1

    def new_op(op: int, a: int, b: int) -> int:
        opcode.append(op)
        scale.append(0.0)
        v = len(opcode) - 1
        edges.append((a, v, 0))
        edges.append((b, v, 1))
        return v

    def keep(i, j):
        bi, bj = i // block_size, j // block_size
        return (i >= blocks * block_size or j >= blocks * block_size
                or bi == bj)

    rows: list[dict[int, int]] = []
    for i in range(n):
        row: dict[int, int] = {}
        for j in range(n):
            if i == j or keep(i, j):
                row[j] = new_input(float(n) if i == j else 1.0)
        rows.append(row)
    # Right-looking Doolittle elimination; fill-in is SUB from a zero input.
    for k in range(n):
        pivot = rows[k][k]
        for i in range(k + 1, n):
            if k not in rows[i]:
                continue
            lik = new_op(OP_DIV, rows[i][k], pivot)
            del rows[i][k]
            for j, ukj in list(rows[k].items()):
                if j <= k:
                    continue
                prod = new_op(OP_MUL, lik, ukj)
                if j in rows[i]:
                    rows[i][j] = new_op(OP_SUB, rows[i][j], prod)
                else:
                    rows[i][j] = new_op(OP_SUB, new_input(0.0), prod)

    num = len(opcode)
    src = np.array([e[0] for e in edges], dtype=np.int64)
    dst = np.array([e[1] for e in edges], dtype=np.int64)
    slot = np.array([e[2] for e in edges], dtype=np.int8)
    order = np.argsort(src, kind="stable")
    ptr = np.zeros(num + 1, dtype=np.int64)
    np.add.at(ptr, src + 1, 1)
    return dict(opcode=np.array(opcode, dtype=np.int8),
                fanout_ptr=np.cumsum(ptr), fanout_dst=dst[order],
                fanout_slot=slot[order],
                entry_scale=np.array(scale, dtype=np.float64))


def input_values(struct: dict, seed: int) -> np.ndarray:
    """[N] float32 initial values: the matrix entries drawn from ``seed``
    (any whole number; a negative one is folded into 64 bits), in the
    original generator's order and arithmetic; 0 elsewhere."""
    scale = struct["entry_scale"]
    entries = np.flatnonzero(scale > 0)
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    out = np.zeros(scale.shape[0], dtype=np.float32)
    out[entries] = (rng.uniform(0.5, 2.0, size=entries.size)
                    * scale[entries]).astype(np.float32)
    return out
