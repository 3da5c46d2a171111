"""Design-space explorer: Pareto frontiers over the overlay config, as in
the reference package.

An exhaustive sweep over a small named space — (scheduler, eject_policy,
grid, placement) — answered through the :class:`~repro_torch.service
.service.PlacementService`, so repeated exploration of the same graph is
nearly free (every point is one service query: cached, batched,
amortized). It returns the whole cycles-vs-area trade-off: every
non-dominated (simulated cycles, PE count) point. Each point's cycle count
is bit-deterministic, so the frontier is too.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

#: Default explorer space. Grids are (nx, ny); placement entries are
#: strategy names or PlacementSpecs.
DEFAULT_SPACE = {
    "scheduler": ("ooo", "inorder"),
    "eject_policy": ("n_first", "priority"),
    "grid": ((4, 4), (8, 8)),
    "placement": ("identity", "anneal"),
}


def pareto_front(points: Sequence[dict],
                 objectives: tuple[str, str] = ("cycles", "num_pes")) -> list:
    """Non-dominated subset of ``points``, both objectives minimized.

    Deterministic: points sort by (objective tuple, name) before the scan,
    so ties always resolve the same way.
    """
    o1, o2 = objectives
    ordered = sorted(points, key=lambda p: (p[o2], p[o1], p["name"]))
    front: list = []
    best = None
    for p in ordered:  # ascending o2: keep strictly improving o1
        if best is None or p[o1] < best:
            front.append(p)
            best = p[o1]
    return front


def explore(graph, *, space: dict | None = None, budget: int | None = 4096,
            max_cycles: int = 4_000_000, service=None, device=None) -> dict:
    """Sweep the config space and return the (cycles, num_pes) frontier.

    Args:
      graph: a :class:`~repro_torch.core.graph.DataflowGraph`.
      space: axes to sweep (defaults to :data:`DEFAULT_SPACE`; give a dict
        with any subset of its keys to narrow an axis).
      budget: annealer proposal budget per search placement (see
        :class:`~repro_torch.service.service.PlacementQuery`).
      max_cycles: per-point simulation budget.
      service: a :class:`~repro_torch.service.service.PlacementService` to
        answer through (shares its cache/surrogates with the rest of a
        stream); ``None`` builds a private one on ``device``.
      device: the private service's device (``None`` = the CUDA card);
        ignored when ``service`` is given.

    Returns a machine-readable record: ``points`` (every swept combo with
    its bit-exact cycle count), ``frontier`` (the Pareto subset), and the
    service ``report`` counters.
    """
    from ..core.overlay import OverlayConfig
    from .service import PlacementQuery, PlacementService

    space = {**DEFAULT_SPACE, **(space or {})}
    service = service or PlacementService(device=device)

    combos = []
    for sched in space["scheduler"]:
        for policy in space["eject_policy"]:
            for nx, ny in space["grid"]:
                for placement in space["placement"]:
                    combos.append((sched, policy, int(nx), int(ny),
                                   placement))

    queries = [
        PlacementQuery(
            graph=graph, nx=nx, ny=ny, objective="cycles", budget=budget,
            cfg=OverlayConfig(scheduler=sched, eject_policy=policy,
                              max_cycles=max_cycles, placement=placement))
        for sched, policy, nx, ny, placement in combos]
    results = service.run_batch(queries)

    points = []
    for (sched, policy, nx, ny, placement), res in zip(combos, results):
        name = (f"{sched}__{policy}__{nx}x{ny}__"
                f"{_placement_name(placement)}")
        points.append({
            "name": name,
            "scheduler": sched,
            "eject_policy": policy,
            "grid": [nx, ny],
            "num_pes": nx * ny,
            "placement": _placement_name(placement),
            "cycles": int(res.cycles),
            "cached": bool(res.cached),
            "key": int(res.key),
        })
    return {
        "space": {k: [str(v) for v in vs] for k, vs in space.items()},
        "points": points,
        "frontier": pareto_front(points),
        "report": service.report(),
    }


def _placement_name(placement) -> str:
    if isinstance(placement, str):
        return placement
    if placement is None:
        return "identity"
    if dataclasses.is_dataclass(placement):
        return placement.strategy
    return str(placement)
