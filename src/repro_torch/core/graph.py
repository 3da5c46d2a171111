"""Dataflow graph IR for the token-dataflow overlay.

A graph is a DAG of binary floating-point operators (the paper's workloads are
dataflow graphs extracted from sparse matrix factorization kernels). Nodes obey
the dataflow firing rule: a node executes once all of its operands have
arrived. INPUT nodes carry initial token values and fire at cycle 0.

The IR is plain numpy (static, host-side); the overlay simulator consumes a
packed per-PE view built by :mod:`repro_torch.core.partition`. This module is
a numpy copy of the reference package's graph IR, kept so that the port never
imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Opcodes. All non-INPUT ops are binary (fanin == 2).
OP_INPUT = 0
OP_ADD = 1
OP_SUB = 2
OP_MUL = 3
OP_DIV = 4  # "safe" divide: a / (b + eps*sign(b)) — identical in ref and sim.

OP_NAMES = {OP_INPUT: "input", OP_ADD: "add", OP_SUB: "sub", OP_MUL: "mul", OP_DIV: "div"}
DIV_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class DataflowGraph:
    """CSR-encoded dataflow DAG.

    Attributes:
      opcode: [N] int8 opcodes.
      fanout_ptr: [N+1] int64 CSR row pointers into fanout arrays.
      fanout_dst: [E] int64 destination node id per edge.
      fanout_slot: [E] int8 operand slot (0 or 1) at the destination.
      initial_values: [N] float32; defined only where opcode == OP_INPUT.
    """

    opcode: np.ndarray
    fanout_ptr: np.ndarray
    fanout_dst: np.ndarray
    fanout_slot: np.ndarray
    initial_values: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.opcode.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.fanout_dst.shape[0])

    def fanin_count(self) -> np.ndarray:
        """[N] number of operands each node waits for (0 for INPUT, 2 else)."""
        return np.where(self.opcode == OP_INPUT, 0, 2).astype(np.int32)

    def fanout_count(self) -> np.ndarray:
        return (self.fanout_ptr[1:] - self.fanout_ptr[:-1]).astype(np.int32)

    def validate(self) -> None:
        n, e = self.num_nodes, self.num_edges
        assert self.fanout_ptr.shape == (n + 1,)
        assert self.fanout_ptr[0] == 0 and self.fanout_ptr[-1] == e
        assert (np.diff(self.fanout_ptr) >= 0).all()
        assert self.fanout_dst.min(initial=0) >= 0
        assert self.fanout_dst.max(initial=-1) < n
        assert set(np.unique(self.fanout_slot)) <= {0, 1}
        # Every non-input node receives exactly one edge per operand slot.
        recv = np.zeros((n, 2), dtype=np.int64)
        np.add.at(recv, (self.fanout_dst, self.fanout_slot.astype(np.int64)), 1)
        non_input = self.opcode != OP_INPUT
        if not (recv[non_input] == 1).all():
            bad = np.where(non_input & ~(recv == 1).all(axis=1))[0][:8]
            raise ValueError(f"nodes with missing/duplicate operands: {bad}")
        if not (recv[~non_input] == 0).all():
            raise ValueError("INPUT nodes must not receive edges")
        self.topological_order()  # raises on cycles

    def topological_order(self) -> np.ndarray:
        """Kahn topological order; raises ValueError on cycles."""
        n = self.num_nodes
        indeg = np.zeros(n, dtype=np.int64)
        np.add.at(indeg, self.fanout_dst, 1)
        order = np.empty(n, dtype=np.int64)
        frontier = list(np.where(indeg == 0)[0])
        k = 0
        ptr, dst = self.fanout_ptr, self.fanout_dst
        while frontier:
            v = frontier.pop()
            order[k] = v
            k += 1
            for u in dst[ptr[v]:ptr[v + 1]]:
                indeg[u] -= 1
                if indeg[u] == 0:
                    frontier.append(int(u))
        if k != n:
            raise ValueError("graph has a cycle")
        return order


def apply_op(opcode: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized ALU semantics shared by the reference evaluator and the sim."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    safe_b = b + np.where(b >= 0, DIV_EPS, -DIV_EPS).astype(np.float32)
    out = np.select(
        [opcode == OP_ADD, opcode == OP_SUB, opcode == OP_MUL, opcode == OP_DIV],
        [a + b, a - b, a * b, a / safe_b],
        default=np.float32(0),
    )
    return out.astype(np.float32)


def reference_evaluate(g: DataflowGraph) -> np.ndarray:
    """Functional oracle: evaluate the DAG in topological order. [N] float32."""
    order = g.topological_order()
    value = np.zeros(g.num_nodes, dtype=np.float32)
    operands = np.zeros((g.num_nodes, 2), dtype=np.float32)
    is_input = g.opcode == OP_INPUT
    value[is_input] = g.initial_values[is_input]
    ptr, dst, slot = g.fanout_ptr, g.fanout_dst, g.fanout_slot
    for v in order:
        if not is_input[v]:
            value[v] = apply_op(g.opcode[v], operands[v, 0], operands[v, 1])
        lo, hi = ptr[v], ptr[v + 1]
        operands[dst[lo:hi], slot[lo:hi].astype(np.int64)] = value[v]
    return value


class GraphBuilder:
    """Convenience builder used by workload generators."""

    def __init__(self) -> None:
        self._op: list[int] = []
        self._init: list[float] = []
        self._edges: list[tuple[int, int, int]] = []  # (src, dst, slot)

    def input(self, value: float) -> int:
        self._op.append(OP_INPUT)
        self._init.append(float(value))
        return len(self._op) - 1

    def op(self, opcode: int, a: int, b: int) -> int:
        assert opcode in (OP_ADD, OP_SUB, OP_MUL, OP_DIV)
        self._op.append(opcode)
        self._init.append(0.0)
        v = len(self._op) - 1
        self._edges.append((a, v, 0))
        self._edges.append((b, v, 1))
        return v

    def build(self, validate: bool = True) -> DataflowGraph:
        n = len(self._op)
        e = len(self._edges)
        src = np.array([s for s, _, _ in self._edges], dtype=np.int64)
        dst = np.array([d for _, d, _ in self._edges], dtype=np.int64)
        slot = np.array([sl for _, _, sl in self._edges], dtype=np.int8)
        order = np.argsort(src, kind="stable")
        src, dst, slot = src[order], dst[order], slot[order]
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(ptr, src + 1, 1)
        ptr = np.cumsum(ptr)
        g = DataflowGraph(
            opcode=np.array(self._op, dtype=np.int8),
            fanout_ptr=ptr,
            fanout_dst=dst,
            fanout_slot=slot,
            initial_values=np.array(self._init, dtype=np.float32),
        )
        if validate:
            g.validate()
        return g
