"""NoC-aware placement cost model, batched over candidate placements.

A candidate placement is a ``[N]`` node -> PE assignment. Its cost has two
terms, both *integer-valued* so every score (and every annealer accept
decision built on score deltas) is bit-deterministic across machines and
devices:

  * **traffic** — hop-weighted NoC load: each dataflow edge pays the
    dimension-ordered hop count of the unidirectional Hoplite torus between
    its endpoint PEs (``(dx mod nx) + (dy mod ny)`` — the torus is one-way,
    so going "back" one column costs ``nx - 1`` hops, exactly like the
    simulator), weighted ``1 + crit_scale * crit / crit_max`` so edges on the
    critical chain count more (they are latency-, not just bandwidth-bound).
  * **slot pressure** — criticality-weighted load balance: each PE's load is
    the sum of its nodes' integer weights (same criticality ramp), and the
    term is the sum of squared loads.

``total = traffic + pressure_weight * pressure``, summed in int64 (the
squared loads of a ~500K-node graph reach ~4e9), as the reference package
sums them. :meth:`CostModel.batch_cost` scores a ``[B, N]`` stack at once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import resolve_device
from ..core.criticality import criticality as _criticality
from ..core.graph import DataflowGraph


def edge_endpoints(g: DataflowGraph) -> tuple[np.ndarray, np.ndarray]:
    """CSR fanout lists -> flat ([E] src, [E] dst) int32 endpoint arrays."""
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int32), g.fanout_count())
    return src, g.fanout_dst.astype(np.int32)


def integer_weights(crit: np.ndarray, crit_scale: int) -> np.ndarray:
    """[N] int32 weights ``1 + crit_scale * crit / crit_max`` (floored)."""
    c = np.asarray(crit, dtype=np.int64)
    c = c - c.min() if c.size else c  # neg_slack labels are <= 0
    top = max(1, int(c.max(initial=0)))
    return (1 + (crit_scale * c) // top).astype(np.int32)


def edge_tables(
    g: DataflowGraph, *, metric: str = "height", crit_scale: int = 3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flat integer scoring tables ``(src, dst, w_edge, w_node)`` for ``g``.

    ``w_node`` is the criticality ramp :func:`integer_weights`; each edge
    carries its *source* node's weight (the token that travels is the
    source's result). The cost model and the multilevel coarsener
    (:mod:`repro_torch.place.coarsen`) share this one definition.
    """
    crit = _criticality(g, metric)
    src, dst = edge_endpoints(g)
    w_node = integer_weights(crit, crit_scale)
    return src, dst, w_node[src].astype(np.int32), w_node


def torus_hops(src_pe, dst_pe, nx: int, ny: int):
    """Dimension-ordered hop count on the unidirectional nx x ny torus.

    PE ids follow the overlay convention ``pe = x * ny + y``. Integer
    tensors; ``%`` is a floored modulo, as ``jnp.mod`` is.
    """
    sx, sy = src_pe // ny, src_pe % ny
    dx_, dy_ = dst_pe // ny, dst_pe % ny
    return (dx_ - sx) % nx + (dy_ - sy) % ny


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Static per-graph scoring tables (on one torch device) + the cost
    functions."""

    nx: int
    ny: int
    src: torch.Tensor          # [E] int64 edge source node
    dst: torch.Tensor          # [E] int64 edge destination node
    w_edge: torch.Tensor       # [E] int32 criticality edge weight
    w_node: torch.Tensor       # [N] int32 criticality node weight
    pressure_weight: int

    @property
    def num_pes(self) -> int:
        return self.nx * self.ny

    @property
    def device(self) -> torch.device:
        return self.w_node.device

    def _pe(self, node_pe) -> torch.Tensor:
        return torch.as_tensor(np.asarray(node_pe) if not isinstance(
            node_pe, torch.Tensor) else node_pe, device=self.device
        ).to(torch.int64)

    def traffic(self, node_pe) -> torch.Tensor:
        """int64 hop-weighted traffic of one ``[N]`` placement (or ``[B]``
        of a ``[B, N]`` stack)."""
        pe = self._pe(node_pe)
        hops = torus_hops(pe[..., self.src], pe[..., self.dst],
                          self.nx, self.ny)
        return (self.w_edge.to(torch.int64) * hops).sum(-1)

    def loads(self, node_pe) -> torch.Tensor:
        """[P] (or [B, P]) int64 criticality-weighted node load per PE."""
        pe = self._pe(node_pe)
        w = self.w_node.to(torch.int64).expand(pe.shape)
        out = torch.zeros(*pe.shape[:-1], self.num_pes, dtype=torch.int64,
                          device=self.device)
        return out.scatter_add_(-1, pe, w)

    def pressure(self, node_pe) -> torch.Tensor:
        loads = self.loads(node_pe)
        return (loads * loads).sum(-1)

    def cost(self, node_pe) -> torch.Tensor:
        """int64 cost of one [N] placement (a 0-dim tensor)."""
        return (self.traffic(node_pe)
                + self.pressure_weight * self.pressure(node_pe))

    def batch_cost(self, placements) -> torch.Tensor:
        """[B] int64 costs of a stacked [B, N] candidate batch."""
        pe = self._pe(placements)
        if pe.dim() != 2:
            raise ValueError(f"placements must be [B, N], got {tuple(pe.shape)}")
        return self.cost(pe)


def build_cost_model(
    g: DataflowGraph,
    nx: int,
    ny: int,
    *,
    metric: str = "height",
    crit_scale: int = 3,
    pressure_weight: int = 1,
    device=None,
) -> CostModel:
    """Precompute the scoring tables for ``g`` on an ``nx x ny`` grid, on
    ``device`` (``None`` = the CUDA card; raises without one)."""
    dev = resolve_device(device)
    src, dst, w_edge, w_node = edge_tables(
        g, metric=metric, crit_scale=crit_scale)
    return CostModel(
        nx=nx, ny=ny,
        src=torch.from_numpy(src.astype(np.int64)).to(dev),
        dst=torch.from_numpy(dst.astype(np.int64)).to(dev),
        w_edge=torch.from_numpy(w_edge).to(dev),   # edge carries its source's weight
        w_node=torch.from_numpy(w_node).to(dev),
        pressure_weight=int(pressure_weight),
    )
