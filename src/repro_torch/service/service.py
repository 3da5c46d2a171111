"""The batched placement-and-simulation service, as in the reference package.

:class:`PlacementService` answers streams of :class:`PlacementQuery`
requests — the fleet-scale spelling of the paper's one-time static
labeling/placement pass. Three amortization layers, in lookup order:

1. **Content-hash result cache** (:mod:`repro_torch.service.cache`): repeat
   graphs are free. A hit returns the cached placement and bit-exact cycle
   counts with ZERO simulations — bit-determinism is what makes a cached
   integer indistinguishable from a fresh one.
2. **Batched search**: cache-missing queries that share graph tables and
   static annealer knobs fan out through ONE search
   (:func:`repro_torch.place.anneal.anneal_placements`: on the card one
   launch of the anneal kernel for all their ladders, each element
   bit-identical to its solo run). Guided queries share ONE surrogate per
   (graph, grid) family, fitted on first use and reused for the rest of the
   stream.
3. **Shape-class simulation**: placed memories are padded to each query
   group's joint ``(lmax, emax)`` shape class
   (:func:`repro_torch.place.api.shape_class`), so a group of graphs of
   different sizes runs one memory shape.

Searches, surrogate fits and simulations run on the service's device,
resolved once (``device=None`` = the CUDA card; raises without one).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .cache import CachedResult, ResultCache
from .hashing import graph_digest, query_key

#: SimResult integer counters worth caching alongside the cycle count.
_STAT_FIELDS = ("delivered", "deflections", "busy_cycles",
                "noc_deflections", "eject_deflections")


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementQuery:
    """One (graph, grid, objective, budget) request.

    ``objective`` — ``"cycles"`` (resolve a placement, then simulate it:
    the answer carries bit-exact cycle counts) or ``"cost"`` (resolve only;
    the answer carries the integer placement-model cost and runs zero
    simulations — the in-loop proxy objective).

    ``budget`` — total annealer proposals (``replicas * rounds * steps``)
    for search placements. ``None`` keeps the spec's own knobs; an explicit
    budget deterministically derives ``rounds`` from the default ladder
    (ignored for static strategies and for specs with explicit ``anneal``
    knobs, which win).

    ``cfg`` — the :class:`~repro_torch.core.overlay.OverlayConfig` to
    answer under (``None`` = defaults); ``cfg.placement`` accepts
    ``str | PlacementSpec | None`` like everywhere else.
    """

    graph: Any
    nx: int
    ny: int
    objective: str = "cycles"
    budget: int | None = None
    cfg: Any = None

    def __post_init__(self):
        if self.objective not in ("cycles", "cost"):
            raise ValueError(
                f"objective must be 'cycles' or 'cost', "
                f"got {self.objective!r}")
        if self.nx < 1 or self.ny < 1:
            raise ValueError(f"grid must be >= 1x1, got {self.nx}x{self.ny}")
        if self.budget is not None and self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")


@dataclasses.dataclass(frozen=True, eq=False)
class QueryResult:
    """Answer to one query. ``cached`` marks a zero-simulation cache hit."""

    key: int
    node_pe: np.ndarray
    objective: str
    cycles: int | None
    cost: int | None
    stats: dict
    cached: bool


def effective_config(q: PlacementQuery):
    """The canonical OverlayConfig a query actually runs under.

    Folds ``q.budget`` into the placement spec (deterministically — the
    same query always derives the same knobs, so its cache key is stable)
    and returns a config whose ``placement`` is the final canonical spec.
    """
    from ..core.overlay import OverlayConfig
    from ..place.spec import SEARCH_STRATEGIES, AnnealConfig, PlacementSpec

    cfg = q.cfg if q.cfg is not None else OverlayConfig()
    spec = cfg.placement  # canonical PlacementSpec (IDENTITY for identity)
    if not isinstance(spec, PlacementSpec):
        raise TypeError(
            "the placement service takes a strategy name or a PlacementSpec "
            f"as cfg.placement, got {spec!r}")
    if (q.budget is not None and spec.strategy in SEARCH_STRATEGIES
            and spec.anneal is None):
        base = AnnealConfig(seed=spec.seed)
        rounds = max(1, q.budget // (base.replicas * base.steps))
        spec = dataclasses.replace(
            spec, anneal=dataclasses.replace(base, rounds=rounds))
    return dataclasses.replace(cfg, placement=spec)


def _result_stats(res) -> dict:
    return {k: int(getattr(res, k)) for k in _STAT_FIELDS}


class PlacementService:
    """Answer placement queries with caching, batching, and amortization.

    ``cache_dir`` (``$REPRO_SERVICE_CACHE`` through
    :func:`repro_torch.service.cache.service_cache_dir` is the usual
    choice) turns on on-disk persistence; the default is a process-local
    LRU so hit/miss counters stay deterministic. ``device`` is where every
    search, surrogate fit and simulation runs (``None`` = the CUDA card).
    """

    def __init__(self, cache: ResultCache | None = None, *,
                 capacity: int = 4096, cache_dir: str | None = None,
                 device=None):
        from ..api import resolve_device

        self.device = resolve_device(device)
        self.cache = cache if cache is not None else ResultCache(
            capacity=capacity, directory=cache_dir)
        self._guides: dict = {}   # surrogate models shared across the stream
        self.counters = {
            "queries": 0,          # queries answered
            "simulations": 0,      # engine runs (cache hits add zero)
            "anneals": 0,          # search placements resolved
            "batched_anneals": 0,  # ... of which rode a batched fan-out
            "surrogate_fits": 0,   # guided-search models fitted (not reused)
        }

    # -- surrogate sharing --------------------------------------------------

    def _guide_for(self, g, digest: bytes, nx: int, ny: int, spec):
        """One fitted surrogate per (graph, grid, fit knobs) for the whole
        stream; ``place.api.resolve`` coarsen-transfers it inside the
        multilevel pipeline."""
        key = (digest, nx, ny, spec.metric, spec.guide_train, spec.seed,
               spec.anneal_config.crit_scale)
        model = self._guides.get(key)
        if model is None:
            from .. import surrogate as sg

            model, _, cycles = sg.fit_from_sim(
                g, nx, ny, n_train=spec.guide_train, seed=spec.seed,
                metric=spec.metric, crit_scale=spec.anneal_config.crit_scale,
                device=self.device)
            self.counters["surrogate_fits"] += 1
            self.counters["simulations"] += len(cycles)
            self._guides[key] = model
        return model

    # -- placement resolution ----------------------------------------------

    def _resolve_placements(self, items: list[dict]) -> None:
        """Fill ``item["node_pe"]`` (+ ``item["cost"]``) for every item.

        Plain-anneal queries sharing (graph, grid, metric, static annealer
        knobs) batch through :func:`repro_torch.place.anneal_placements` —
        one search per group; everything else resolves solo via
        :func:`repro_torch.place.api.resolve`.
        """
        from ..place import anneal_placements
        from ..place.api import resolve

        dev = self.device
        groups: dict = {}
        for it in items:
            spec = it["cfg"].placement
            acfg = spec.anneal_config
            if spec.strategy == "anneal" and spec.guide is None:
                gk = (it["digest"], it["nx"], it["ny"], spec.metric,
                      spec.init, acfg.replicas, acfg.rounds, acfg.steps,
                      acfg.crit_scale, acfg.pressure_weight)
                groups.setdefault(gk, []).append(it)
            else:
                groups.setdefault(id(it), []).append(it)

        for members in groups.values():
            it0 = members[0]
            spec0 = it0["cfg"].placement
            if (len(members) > 1 and spec0.strategy == "anneal"
                    and spec0.guide is None):
                inits = []
                for it in members:
                    sp = it["cfg"].placement
                    inits.append(None if sp.init == "random" else resolve(
                        it["graph"], it["nx"], it["ny"],
                        dataclasses.replace(sp, strategy=sp.init),
                        device=dev))
                results = anneal_placements(
                    it0["graph"], it0["nx"], it0["ny"],
                    [it["cfg"].placement.anneal_config for it in members],
                    metric=spec0.metric, inits=inits, device=dev)
                for it, r in zip(members, results):
                    it["node_pe"] = r.node_pe
                    it["cost"] = r.cost
                self.counters["anneals"] += len(members)
                self.counters["batched_anneals"] += len(members)
                continue
            for it in members:
                spec = it["cfg"].placement
                guide = None
                if spec.guide == "surrogate":
                    guide = self._guide_for(it["graph"], it["digest"],
                                            it["nx"], it["ny"], spec)
                it["node_pe"] = resolve(it["graph"], it["nx"], it["ny"],
                                        spec, guide_model=guide, device=dev)
                it["cost"] = None
                if spec.strategy in ("anneal", "multilevel"):
                    self.counters["anneals"] += 1

    def _model_cost(self, it: dict) -> int:
        """Integer placement-model cost of a resolved item (cost objective
        for items whose search didn't already report one)."""
        from ..place.cost import build_cost_model

        spec = it["cfg"].placement
        acfg = spec.anneal_config
        model = build_cost_model(
            it["graph"], it["nx"], it["ny"], metric=spec.metric,
            crit_scale=acfg.crit_scale,
            pressure_weight=acfg.pressure_weight, device=self.device)
        return int(model.cost(np.asarray(it["node_pe"])))

    # -- simulation ---------------------------------------------------------

    def _simulate(self, items: list[dict]) -> None:
        """Simulate resolved items, shape-class-grouped.

        Items sharing a grid + sim config land in one padded ``(lmax,
        emax)`` shape class, even when the group mixes graphs of different
        sizes (``scan``-like policies, whose latency models the memory
        depth, keep each memory's own slot depth).
        """
        from ..core import schedulers
        from ..core.overlay import _simulate_batch
        from ..place.api import (_latency_depends_on_words, shape_class,
                                 uniform_graph_memories)

        groups: dict = {}
        for it in items:
            sim_cfg = dataclasses.replace(it["cfg"], placement=None)
            groups.setdefault((it["nx"], it["ny"], sim_cfg), []).append(it)

        for (nx, ny, sim_cfg), members in groups.items():
            wants = schedulers.get(sim_cfg.scheduler).wants_criticality_order
            pad_lmax = not _latency_depends_on_words([sim_cfg])
            lmax, emax = shape_class(
                [(it["graph"], it["node_pe"]) for it in members], nx, ny)
            for it in members:
                spec = it["cfg"].placement
                gm = uniform_graph_memories(
                    it["graph"], nx, ny, [it["node_pe"]],
                    criticality_order=wants, metric=spec.metric,
                    pad_lmax=pad_lmax, min_lmax=lmax, min_emax=emax)[0]
                res = _simulate_batch(gm, [sim_cfg], device=self.device)[0]
                self.counters["simulations"] += 1
                it["cycles"] = int(res.cycles)
                it["stats"] = _result_stats(res)

    # -- the front door -----------------------------------------------------

    def run_batch(self, queries) -> list[QueryResult]:
        """Answer a batch of queries; order-preserving.

        Repeat keys — against the cache or within the batch — are answered
        exactly once; every duplicate serves from the first resolution with
        zero additional simulations and bit-exact integers.
        """
        queries = list(queries)
        self.counters["queries"] += len(queries)
        plans = []
        for q in queries:
            cfg = effective_config(q)
            digest = graph_digest(q.graph)
            key = query_key(q.graph, q.nx, q.ny, cfg, q.objective)
            plans.append({"query": q, "cfg": cfg, "digest": digest,
                          "key": key})

        resolved: dict[int, CachedResult] = {}
        fresh: dict[int, bool] = {}
        work: list[dict] = []
        for p in plans:
            key = p["key"]
            if key in resolved or key in fresh:
                continue  # within-batch duplicate: first occurrence answers
            entry = self.cache.get(key)
            if entry is not None:
                resolved[key] = entry
                continue
            fresh[key] = True
            q = p["query"]
            work.append({"key": key, "graph": q.graph, "nx": q.nx,
                         "ny": q.ny, "objective": q.objective,
                         "cfg": p["cfg"], "digest": p["digest"]})

        if work:
            self._resolve_placements(work)
            sim_items = [it for it in work if it["objective"] == "cycles"]
            if sim_items:
                self._simulate(sim_items)
            for it in work:
                if it["objective"] == "cost" and it["cost"] is None:
                    it["cost"] = self._model_cost(it)
                entry = CachedResult(
                    key=it["key"],
                    node_pe=np.asarray(it["node_pe"], dtype=np.int32),
                    objective=it["objective"],
                    cycles=it.get("cycles"),
                    cost=it.get("cost"),
                    stats=it.get("stats", {}))
                self.cache.put(it["key"], entry)
                resolved[it["key"]] = entry

        out = []
        for p in plans:
            e = resolved[p["key"]]
            out.append(QueryResult(
                key=e.key, node_pe=e.node_pe, objective=e.objective,
                cycles=e.cycles, cost=e.cost, stats=dict(e.stats),
                cached=p["key"] not in fresh))
        return out

    def query(self, q: PlacementQuery) -> QueryResult:
        """Answer one query (a batch of one)."""
        return self.run_batch([q])[0]

    def report(self) -> dict:
        """Counters: cache + execution, all exact ints (and the hit rate)."""
        rep = {f"cache_{k}": v for k, v in self.cache.report().items()}
        rep.update(self.counters)
        return rep
