"""Placement resolution + overlay integration entry points, as in the
reference package.

  * :func:`resolve` turns a :class:`~repro_torch.place.spec.PlacementSpec`
    (or a strategy name, an explicit array, or ``None`` = identity) into a
    concrete ``[N]`` node -> PE vector;
  * :func:`graph_memory` / :func:`graph_memory_for_config` pack a placed
    graph into the :class:`~repro_torch.core.partition.GraphMemory` the
    engines consume (criticality-sorted slots via
    :mod:`repro_torch.place.slots`);
  * :func:`evaluate_placements` scores candidate placements by *simulated
    cycle count*, each candidate's config sweep through the port's batched
    engine (``repro_torch.run(gm, batch=...)``);
  * :func:`config_hillclimb` is the greedy coordinate-descent search over
    (placement x scheduler x select latency x eject capacity).

Searches and simulations run on ``device`` (``None`` = the CUDA card; pass
``"cpu"`` to run on the CPU); with ``mesh=`` the simulations run with the
PE grid tiled over the mesh (:mod:`repro_torch.core.distributed`).

Heavyweight imports (overlay) are deferred into the functions:
``core.overlay`` itself imports this module for placement threading, so the
module level must stay cycle-free.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.graph import DataflowGraph
from .anneal import anneal_placement
from .spec import PlacementSpec, explicit
from .spec import resolve as resolve_spec

def resolve(g: DataflowGraph, nx: int, ny: int, placement=None, *,
            guide_model=None, device=None) -> np.ndarray:
    """[N] node -> PE vector for ``placement`` on the ``nx x ny`` grid.

    ``placement`` is a PlacementSpec, a strategy name, an explicit [N] array
    (or :class:`~repro_torch.place.spec.PlacementArray`, returned as-is), or
    ``None`` (identity = the partitioner's default round-robin — the layout
    all committed benchmark numbers use). A search runs on ``device``.

    A spec with ``guide="surrogate"`` runs the search with the two-stage
    surrogate accept; ``guide_model`` supplies a prefitted
    :class:`~repro_torch.surrogate.model.SurrogateModel` for it (must match
    this graph and grid), otherwise one is fitted on the spot from
    ``spec.guide_train`` self-generated placements simulated on ``device``.
    """
    node_pe = explicit(placement)
    if node_pe is not None:
        return node_pe
    from ..core import partition

    spec = resolve_spec(placement)
    num_pes = nx * ny
    guide = None
    if spec.guide == "surrogate":  # spec validation pins strategy to a search
        guide = guide_model
        if guide is None:
            from .. import surrogate as sg

            guide, _, _ = sg.fit_from_sim(
                g, nx, ny, n_train=spec.guide_train, seed=spec.seed,
                metric=spec.metric,
                crit_scale=spec.anneal_config.crit_scale, device=device)
    knobs = dict(guide=guide, guide_every=spec.guide_every,
                 guide_margin=spec.guide_margin, device=device)
    if spec.strategy == "anneal":
        init = None  # anneal_placement defaults to random-from-seed
        if spec.init != "random":
            init = resolve(g, nx, ny, PlacementSpec(strategy=spec.init,
                                                    seed=spec.seed))
        return anneal_placement(
            g, nx, ny, spec.anneal_config, metric=spec.metric,
            init=init, **knobs).node_pe
    if spec.strategy == "multilevel":
        from .coarsen import multilevel_anneal

        return multilevel_anneal(
            g, nx, ny, spec.anneal_config, ratio=spec.coarsen_ratio,
            refine=spec.refine if spec.refine is not None else "auto",
            metric=spec.metric, **knobs).node_pe
    strategy = "round_robin" if spec.strategy == "identity" else spec.strategy
    return partition.place_nodes(g, num_pes, strategy, seed=spec.seed)


def _metric(placement) -> str:
    """A placement's criticality metric: its spec's, or the default for an
    explicit array."""
    if explicit(placement) is not None:
        return "height"
    return resolve_spec(placement).metric


def graph_memory(g: DataflowGraph, nx: int, ny: int, placement=None, *,
                 criticality_order: bool = True, metric: str | None = None,
                 device=None):
    """Resolve ``placement`` and pack the per-PE graph memory."""
    from ..core import partition

    node_pe = resolve(g, nx, ny, placement, device=device)
    return partition.build_graph_memory(
        g, nx, ny, placement=node_pe,
        metric=metric or _metric(placement),
        criticality_order=criticality_order)


def graph_memory_for_config(g: DataflowGraph, nx: int, ny: int, cfg, *,
                            device=None):
    """GraphMemory for an :class:`~repro_torch.core.overlay.OverlayConfig`:
    honors ``cfg.placement`` and the scheduler's preferred memory layout."""
    from ..core import schedulers

    wants = schedulers.get(cfg.scheduler).wants_criticality_order
    return graph_memory(g, nx, ny, cfg.placement, criticality_order=wants,
                        device=device)


def uniform_graph_memories(g: DataflowGraph, nx: int, ny: int, node_pes,
                           *, criticality_order: bool = True,
                           metric: str = "height",
                           pad_lmax: bool = True,
                           min_lmax: int = 0, min_emax: int = 0) -> list:
    """Pack one GraphMemory per ``[N]`` node -> PE vector, all with identical
    array shapes.

    Slot depth (``lmax``) and per-PE edge capacity (``emax``) depend on the
    placement; every memory is padded to the candidate-set maxima (padding
    never moves cycle counts: empty slots and edges are inert), as the
    reference pads them for one compiled program.

    ``pad_lmax=False`` keeps each memory's own slot depth (only ``emax`` is
    unified) — needed when a scheduler *models* latency from the memory depth
    (the ``scan`` policy's word-count sweep), where padding would change
    cycle counts.

    ``metric`` is one criticality metric for the whole set or one per
    placement (slot ordering only — it never moves the unified shapes).
    ``min_lmax`` / ``min_emax`` raise the padding floor beyond this set's
    own maxima (see :func:`shape_class`).
    """
    from ..core.partition import build_graph_memory, packed_shape

    node_pes = [np.asarray(p, dtype=np.int32) for p in node_pes]
    metrics = ([metric] * len(node_pes) if isinstance(metric, str)
               else list(metric))
    if len(metrics) != len(node_pes):
        raise ValueError(
            f"need one metric or one per placement; got {len(metrics)} "
            f"for {len(node_pes)} placements")
    shapes = [packed_shape(g, pe, nx * ny) for pe in node_pes]
    lmax = max([l for l, _ in shapes] + [min_lmax, 1])
    emax = max([e for _, e in shapes] + [min_emax, 1])
    return [build_graph_memory(
        g, nx, ny, placement=pe, metric=m,
        criticality_order=criticality_order,
        min_lmax=lmax if pad_lmax else 0, min_emax=emax)
        for pe, m in zip(node_pes, metrics)]


def shape_class(graphs_and_pes, nx: int, ny: int) -> tuple[int, int]:
    """Shared ``(lmax, emax)`` padding floor for a mixed-graph query group:
    the maxima over ``(DataflowGraph, [N] node_pe)`` pairs, fed to
    :func:`uniform_graph_memories` (or :func:`evaluate_placements`) as
    ``min_lmax`` / ``min_emax``."""
    from ..core.partition import packed_shape

    lmax, emax = 1, 1
    for g, pe in graphs_and_pes:
        l, e = packed_shape(g, np.asarray(pe, dtype=np.int32), nx * ny)
        lmax, emax = max(lmax, l), max(emax, e)
    return lmax, emax


def _latency_depends_on_words(cfg_list) -> bool:
    """True when any config's exposed select latency is a function of the
    RDY word count (e.g. the ``scan`` policy) — lmax padding would then be a
    *model* change, not just an engine one."""
    from ..core import schedulers

    return any(schedulers.get(c.scheduler).sel_lat(c, 1)
               != schedulers.get(c.scheduler).sel_lat(c, 2)
               for c in cfg_list)


def simulate_placements(g: DataflowGraph, nx: int, ny: int, node_pes, cfg=None,
                        *, mesh=None, criticality_order: bool = True,
                        metric: str = "height", device=None) -> list:
    """Simulated :class:`~repro_torch.core.overlay.SimResult` per ``[N]``
    vector, the memories shape-unified (:func:`uniform_graph_memories`);
    with ``mesh`` each through the sharded batched engine."""
    from ..api import resolve_device
    from ..core import distributed, overlay

    dev = resolve_device(device)
    cfg = cfg or overlay.OverlayConfig()
    gms = uniform_graph_memories(
        g, nx, ny, node_pes, criticality_order=criticality_order,
        metric=metric, pad_lmax=not _latency_depends_on_words([cfg]))
    if mesh is None:
        return [overlay._simulate_batch(gm, [cfg], device=dev)[0]
                for gm in gms]
    return [distributed._simulate_batch_sharded(gm, mesh, [cfg], device=dev)[0]
            for gm in gms]


def evaluate_placements(g: DataflowGraph, nx: int, ny: int, placements,
                        cfgs=None, mesh=None, *, prune: str | None = None,
                        keep_top: int = 8, surrogate=None,
                        surrogate_train: int = 24,
                        min_lmax: int = 0, min_emax: int = 0,
                        device=None) -> dict:
    """Score candidate placements by simulated cycle count.

    Args:
      placements: ``{name: spec | strategy | [N] array}``.
      cfgs: one OverlayConfig, a sequence of them (swept per placement via
        the batched engine), or None for the default config.
      mesh: a ``DeviceMesh`` (see :func:`repro_torch.run`): the evaluations
        (and an on-the-spot surrogate fit's simulations) then run with the
        PE grid tiled over the mesh.
      prune: ``"surrogate"`` ranks the candidates with a fitted
        cycle-prediction model from :mod:`repro_torch.surrogate` and
        simulates only the ``keep_top`` best-predicted ones (the returned
        dict then contains just those names). ``surrogate`` supplies a
        fitted :class:`~repro_torch.surrogate.model.SurrogateModel` (built
        for this graph and grid); ``None`` fits one on the spot from
        ``surrogate_train`` self-generated simulated placements. With a
        config sweep, the ranking (and any on-the-spot fit) follows the
        first config only.
      min_lmax, min_emax: raise the candidate memories' padding floor (see
        :func:`shape_class`).
      device: where searches and simulations run (``None`` = the CUDA
        card).

    Returns:
      ``{name: SimResult}`` (or ``{name: [SimResult, ...]}`` with a config
      sweep). Candidate memories are shape-unified
      (:func:`uniform_graph_memories`).
    """
    import dataclasses

    from ..api import resolve_device
    from ..core import distributed, overlay, schedulers

    dev = resolve_device(device)
    single = cfgs is None or not isinstance(cfgs, (list, tuple))
    cfg_list = [cfgs or overlay.OverlayConfig()] if single else list(cfgs)
    wants_set = {schedulers.get(c.scheduler).wants_criticality_order
                 for c in cfg_list}
    if len(wants_set) != 1:
        # One packed memory per placement serves the whole sweep; mixed
        # layout preferences would silently skew non-first schedulers.
        raise ValueError(
            "evaluate_placements needs schedulers with a uniform "
            "wants_criticality_order per call; split the config sweep by "
            "memory layout")
    wants = wants_set.pop()

    names = list(placements)
    node_pes = [resolve(g, nx, ny, placements[k], device=dev) for k in names]
    # Slot ordering honors each spec's own criticality metric (explicit
    # arrays have no spec and take the default), exactly like graph_memory.
    metrics = [_metric(placements[k]) for k in names]

    if prune is not None:
        if prune != "surrogate":
            raise ValueError(f"unknown prune mode {prune!r}; "
                             f"known: 'surrogate'")
        from .. import surrogate as sg

        model = surrogate
        if model is None:
            model, _, _ = sg.fit_from_sim(
                g, nx, ny, cfg=cfg_list[0], n_train=surrogate_train,
                mesh=mesh, device=dev)
        keep = model.rank(np.stack(node_pes), device=dev)[:max(1, keep_top)]
        names = [names[i] for i in keep]
        node_pes = [node_pes[i] for i in keep]
        metrics = [metrics[i] for i in keep]

    gms = uniform_graph_memories(
        g, nx, ny, node_pes, criticality_order=wants, metric=metrics,
        pad_lmax=not _latency_depends_on_words(cfg_list),
        min_lmax=min_lmax, min_emax=min_emax)
    # The memories are already placed: cfg.placement is dead weight here.
    cfg_list = [dataclasses.replace(c, placement=None) for c in cfg_list]
    out = {}
    for name, gm in zip(names, gms):
        if mesh is None:
            res = overlay._simulate_batch(gm, cfg_list, device=dev)
        else:
            res = distributed._simulate_batch_sharded(gm, mesh, cfg_list,
                                                      device=dev)
        out[name] = res[0] if single else res
    return out


# ---------------------------------------------------------------------------
# Greedy coordinate-descent over the overlay config space (incl. placement).
# ---------------------------------------------------------------------------

#: Axes of the overlay-config search space; ``scheduler`` is filled from the
#: policy registry at call time.
HILLCLIMB_SPACE = {
    "placement": ["round_robin", "clustered", "bulk_clustered",
                  "critical_chain", "anneal"],
    "scheduler": None,
    "select_latency": [None, 1, 2, 4],
    "eject_capacity": [1, 2],
}


def config_hillclimb(g: DataflowGraph, nx: int, ny: int, *,
                     max_cycles: int = 4_000_000, seed: int = 0,
                     space: dict | None = None, device=None) -> dict:
    """Greedy coordinate descent, one batched run per neighborhood group.

    Each step proposes every single-axis change to the current config;
    unseen neighbors sharing a (placement, eject capacity, memory layout)
    triple evaluate through ONE batched run. Placement axes resolve through
    :func:`resolve` (so ``"anneal"`` runs the placer once and reuses the
    result). Returns a machine-readable record: trajectory, best config,
    best cycles, evaluation count, wall seconds.
    """
    from ..api import resolve_device
    from ..core import schedulers
    from ..core.overlay import OverlayConfig, _simulate_batch

    dev = resolve_device(device)
    space = dict(space or HILLCLIMB_SPACE)
    if space.get("scheduler") is None:
        space["scheduler"] = sorted(schedulers.REGISTRY)

    placed: dict = {}    # strategy -> node_pe
    gms: dict = {}       # (strategy, wants_criticality_order) -> GraphMemory

    def gm_for(strategy, wants):
        key = (strategy, wants)
        if key not in gms:
            if strategy not in placed:
                placed[strategy] = resolve(
                    g, nx, ny, PlacementSpec(strategy=strategy, seed=seed),
                    device=dev)
            gms[key] = graph_memory(g, nx, ny, placed[strategy],
                                    criticality_order=wants)
        return gms[key]

    n_evals = [0]
    seen: dict = {}  # config tuple -> cycles (configs revisit across steps)

    def evaluate(points):
        """[{axis: value}] -> [cycles] (inf when the config never finishes,
        so the search just steps around it)."""
        key = lambda pt: tuple(sorted(pt.items(), key=lambda kv: kv[0]))
        cycles = [seen.get(key(pt)) for pt in points]
        groups: dict = {}
        for i, pt in enumerate(points):
            if cycles[i] is None:
                wants = schedulers.get(pt["scheduler"]).wants_criticality_order
                groups.setdefault(
                    (pt["placement"], pt["eject_capacity"], wants), []).append(i)
        for (strategy, eject, wants), idxs in groups.items():
            n_evals[0] += len(idxs)
            cfgs = [OverlayConfig(scheduler=points[i]["scheduler"],
                                  select_latency=points[i]["select_latency"],
                                  eject_capacity=eject,
                                  max_cycles=max_cycles) for i in idxs]
            for i, r in zip(idxs, _simulate_batch(gm_for(strategy, wants),
                                                  cfgs, device=dev)):
                c = r.cycles if r.done else float("inf")
                cycles[i] = seen[key(points[i])] = c
        return cycles

    def _finite(c):
        return None if c == float("inf") else c

    current = dict(placement="round_robin", scheduler="ooo",
                   select_latency=None, eject_capacity=1)
    t0 = time.time()
    best = evaluate([current])[0]
    trajectory = [{"config": dict(current), "cycles": _finite(best)}]
    while True:
        neighbors = []
        for field, values in space.items():
            for v in values:
                if v != current[field]:
                    neighbors.append(dict(current, **{field: v}))
        res = evaluate(neighbors)
        j = min(range(len(neighbors)), key=res.__getitem__)
        if res[j] >= best:
            break
        current, best = neighbors[j], res[j]
        trajectory.append({"config": dict(current), "cycles": _finite(best)})

    return {
        "space": {k: [str(v) for v in vs] for k, vs in space.items()},
        "trajectory": trajectory,
        "best_config": current,
        "best_cycles": _finite(best),
        "evaluations": n_evals[0],
        "wall_s": round(time.time() - t0, 3),
    }
