"""repro_torch.service — batched placement-as-a-service with content-hash
caching, as in the reference package.

Answers a *stream* of (graph, grid, objective, budget) queries, where
repeat graphs are free and search cost amortizes across the stream:

  * :class:`PlacementQuery` / :class:`QueryResult` — the query schema;
  * :class:`PlacementService` — the front door: content-hash result cache
    (:class:`ResultCache`, :func:`query_key`, keys equal to the
    reference's), batched anneal fan-out (one launch of the anneal kernel
    on the card), one shared surrogate per (graph, grid) family,
    shape-class simulation;
  * :func:`explore` / :func:`pareto_front` — the design-space explorer
    producing Pareto frontiers over (scheduler, eject_policy, grid,
    placement);
  * ``python -m repro_torch.service --smoke`` — the service smoke.

Everything stays bit-deterministic, so cached results and frontier points
equal the reference's BENCH ``service`` counts.
"""
from .cache import CachedResult, ResultCache, service_cache_dir  # noqa: F401
from .explore import DEFAULT_SPACE, explore, pareto_front  # noqa: F401
from .hashing import (  # noqa: F401
    config_token,
    graph_digest,
    query_digest,
    query_key,
)
from .service import (  # noqa: F401
    PlacementQuery,
    PlacementService,
    QueryResult,
    effective_config,
)
