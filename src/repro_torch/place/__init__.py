"""repro_torch.place — placement & mapping, as in the reference package.

The performance story starts *before* the first simulated cycle: a static
one-time placement step decides which PE owns each dataflow node and in what
criticality order each PE's local memory lists them (paper §II).

  * :mod:`.spec`    — hashable placement/annealer configs
    (:class:`PlacementSpec` rides inside ``OverlayConfig``);
  * :mod:`.cost`    — the integer placement cost model (hop-weighted
    Hoplite-torus traffic + criticality-weighted slot pressure), batched;
  * :mod:`.anneal`  — the parallel-tempering / threshold-accepting placer on
    the reference's Threefry stream (:mod:`repro_torch.core.prng`): the CUDA
    kernel of :mod:`repro_torch.kernels.anneal` on the card, torch ops on
    the CPU; bit-identical to the reference for a fixed key;
  * :mod:`.coarsen` — multilevel coarsen -> anneal -> refine (fig1-full
    scale);
  * :mod:`.slots`   — the greedy criticality-sorted slot assigner;
  * :mod:`.api`     — resolution + engine integration (``graph_memory``,
    cycle-count evaluation through the batched engine, the config
    hillclimb).

The surrogate-guided search (``guide=``, ``PlacementSpec(guide=
"surrogate")``) and the surrogate's pruning (``prune="surrogate"``) use
:mod:`repro_torch.surrogate`. With ``mesh=`` the evaluations run through
the sharded engines (:mod:`repro_torch.core.distributed`).
Identity placement (``OverlayConfig(placement=None)``) is the default
everywhere. ``python -m repro_torch.place`` runs the placement smoke.
"""
from .anneal import (  # noqa: F401
    GuidedPlacementResult,
    PlacementResult,
    anneal_placement,
    anneal_placements,
    anneal_tables,
    anneal_tables_many,
)
from .api import (  # noqa: F401
    HILLCLIMB_SPACE,
    config_hillclimb,
    evaluate_placements,
    graph_memory,
    graph_memory_for_config,
    resolve,
    shape_class,
    simulate_placements,
    uniform_graph_memories,
)
from .coarsen import (  # noqa: F401
    MultilevelResult,
    cluster_nodes,
    multilevel_anneal,
    quotient_tables,
)
from .cost import CostModel, build_cost_model, edge_tables, torus_hops  # noqa: F401
from .slots import assign_slots  # noqa: F401
from .spec import AnnealConfig, PlacementArray, PlacementSpec, coerce  # noqa: F401
from .spec import resolve as resolve_spec  # noqa: F401
