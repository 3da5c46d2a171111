"""Hashable placement specifications, as in the reference package.

These are the *configuration* half of :mod:`repro_torch.place`: plain frozen
dataclasses with scalar fields only, so a spec can ride inside
:class:`repro_torch.core.overlay.OverlayConfig` (compared and hashed by the
batched engine's uniformity checks) and key memoization caches. The
*mechanism* half (cost model, annealer, slot assigner) lives in the sibling
modules and consumes these specs. An explicit ``[N]`` node -> PE vector
rides in a config as a :class:`PlacementArray`.

Deliberately import-free of the rest of the package: ``core.overlay``
imports this module, so it must never pull the simulator back in.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Strategies resolvable without search: the identity default plus every
#: static heuristic in :func:`repro_torch.core.partition.place_nodes`.
STATIC_STRATEGIES = (
    "identity", "round_robin", "blocked", "random", "clustered",
    "bulk_clustered", "critical_chain",
)
SEARCH_STRATEGIES = ("anneal", "multilevel")


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    """Knobs of the batched parallel-tempering placer (:mod:`.anneal`).

    The accept rule is *threshold accepting* (Dueck & Scheuer's deterministic
    simulated-annealing variant): replica ``r`` accepts any move whose integer
    cost delta is ``<= threshold[r]``. Thresholds ladder geometrically from
    ``t_max`` down to 0 (replica 0 is a pure greedy descender) and stay fixed
    while parallel-tempering swaps migrate good configurations toward the
    cold end every round. With integer costs this makes the whole search
    bit-deterministic across machines and devices — a requirement for
    the CI-gated placement cycle counts in ``BENCH_overlay.json``.
    """

    replicas: int = 8          # parallel-tempering ladder size
    rounds: int = 24           # swap/best-tracking epochs
    steps: int = 512           # proposals per replica per round
    t_max: float = 64.0        # hottest acceptance threshold (integer-cost units)
    pressure_weight: int = 1   # slot-pressure term weight (integer)
    crit_scale: int = 3        # max extra integer weight for critical edges/nodes
    seed: int = 0              # PRNG key for proposals + the random init

    def __post_init__(self):
        if self.replicas < 1 or self.rounds < 1 or self.steps < 1:
            raise ValueError(f"replicas/rounds/steps must be >= 1, got {self}")
        if self.t_max < 0:
            raise ValueError(f"t_max must be >= 0, got {self.t_max}")


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Names how nodes map onto the PE grid.

    ``strategy`` is ``"identity"`` (keep the partitioner's default
    round-robin — the layout every committed benchmark cycle count was
    recorded with), any static heuristic from
    :func:`repro_torch.core.partition.place_nodes`, ``"anneal"`` (NoC-aware
    search: random init from ``seed``, improved by
    :mod:`repro_torch.place.anneal` under ``anneal`` knobs), or
    ``"multilevel"`` (coarsen ~``coarsen_ratio``x, anneal cluster moves under
    ``anneal`` knobs, uncoarsen, then refine under ``refine`` knobs — the
    fig1-full-scale pipeline in :mod:`repro_torch.place.coarsen`).
    ``metric`` picks the criticality labeling used for slot assignment and
    the cost model's weights.

    ``guide="surrogate"`` upgrades either search strategy to the two-stage
    surrogate-guided accept (knobs ``guide_every`` / ``guide_margin`` /
    ``guide_train`` below; mechanism in :mod:`repro_torch.surrogate.delta`);
    in the multilevel pipeline both the coarse cluster-level phase and the
    fine refinement are guided.
    """

    strategy: str = "identity"
    seed: int = 0
    metric: str = "height"
    anneal: AnnealConfig | None = None
    #: starting point for "anneal": "random" (the baseline the placer is
    #: guaranteed to never score worse than) or any static strategy.
    init: str = "random"
    #: "anneal"/"multilevel" only: ``"surrogate"`` switches on the two-stage
    #: accept — a ridge surrogate fitted on ``guide_train`` self-generated
    #: simulated placements (:func:`repro_torch.surrogate.fit_from_sim`,
    #: seeded from ``seed``) pre-screens every proposal via exact O(degree)
    #: incremental features, and only promising moves reach the integer
    #: cost rule. ``None`` (default) is the plain search.
    guide: str | None = None
    #: guided only: apply the surrogate gate on every k-th proposal of a
    #: round (1 = every proposal).
    guide_every: int = 1
    #: guided only: accept threshold on the predicted cycle delta — moves
    #: predicted to add more than this many cycles are rejected before the
    #: cost rule; ``inf`` disables the gate (the unguided search, bit for
    #: bit).
    guide_margin: float = 0.0
    #: guided only: simulated training placements for the auto-fitted
    #: surrogate when :func:`repro_torch.place.api.resolve` has to fit one.
    guide_train: int = 24
    #: "multilevel" only: target nodes per cluster for the coarsening pass
    #: (the graph collapses ~coarsen_ratio x before the coarse anneal).
    coarsen_ratio: int = 32
    #: "multilevel" only: budget of the bounded fine-grained refinement
    #: anneal after uncoarsening (None = the small default derived from
    #: ``anneal`` by :func:`repro_torch.place.coarsen.default_refine`).
    refine: AnnealConfig | None = None

    def __post_init__(self):
        known = STATIC_STRATEGIES + SEARCH_STRATEGIES
        if self.strategy not in known:
            raise ValueError(
                f"unknown placement strategy {self.strategy!r}; known: {known}")
        if self.init not in STATIC_STRATEGIES:
            raise ValueError(
                f"unknown anneal init strategy {self.init!r}; "
                f"known: {STATIC_STRATEGIES}")
        if self.anneal is not None and not isinstance(self.anneal, AnnealConfig):
            raise TypeError(f"anneal must be an AnnealConfig, got {self.anneal!r}")
        if self.refine is not None and not isinstance(self.refine, AnnealConfig):
            raise TypeError(f"refine must be an AnnealConfig, got {self.refine!r}")
        if self.coarsen_ratio < 1:
            raise ValueError(
                f"coarsen_ratio must be >= 1, got {self.coarsen_ratio}")
        if self.guide not in (None, "surrogate"):
            raise ValueError(
                f"unknown guide {self.guide!r}; known: None, 'surrogate'")
        if self.guide is not None and self.strategy not in SEARCH_STRATEGIES:
            # Silently ignoring the guide on a static strategy would let a
            # "guided" benchmark quietly run an unguided placement.
            raise ValueError(
                f"guide={self.guide!r} requires a search strategy "
                f"{SEARCH_STRATEGIES}, got strategy={self.strategy!r}")
        if self.guide_every < 1:
            raise ValueError(
                f"guide_every must be >= 1, got {self.guide_every}")
        if self.guide_train < 2:
            raise ValueError(
                f"guide_train must be >= 2, got {self.guide_train}")

    @property
    def anneal_config(self) -> AnnealConfig:
        return self.anneal if self.anneal is not None else AnnealConfig(seed=self.seed)


IDENTITY = PlacementSpec()


class PlacementArray:
    """An explicit ``[N]`` node -> PE vector, hashable, as
    :class:`repro_torch.core.overlay.OverlayConfig` stores one: a read-only
    int32 copy, equal to another with the same entries."""

    __slots__ = ("node_pe", "_hash")

    def __init__(self, node_pe):
        a = np.array(node_pe, dtype=np.int32, copy=True).reshape(-1)
        a.setflags(write=False)
        self.node_pe = a
        self._hash = hash(a.tobytes())

    def __eq__(self, other):
        return (isinstance(other, PlacementArray)
                and np.array_equal(self.node_pe, other.node_pe))

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"PlacementArray(n={self.node_pe.shape[0]})"


def explicit(placement):
    """The ``[N]`` int32 vector of an explicit placement (an array or a
    :class:`PlacementArray`), or ``None`` for a name, a spec or ``None``."""
    if isinstance(placement, PlacementArray):
        return placement.node_pe
    if isinstance(placement, np.ndarray):
        return placement.astype(np.int32)
    return None


def resolve(placement) -> PlacementSpec:
    """Normalize any user-facing placement value to a :class:`PlacementSpec`.

    Accepts ``None`` (identity), a strategy-name string, or a spec — the
    single resolution point for ``str | PlacementSpec | None``, so two
    configs that mean the same layout compare and hash equal.
    """
    if placement is None:
        return IDENTITY
    if isinstance(placement, str):
        return PlacementSpec(strategy=placement)
    if isinstance(placement, PlacementSpec):
        return placement
    raise TypeError(
        f"placement must be None, a strategy name, or a PlacementSpec; "
        f"got {placement!r}")


#: Backwards-compatible alias — ``resolve`` is the canonical name.
coerce = resolve
