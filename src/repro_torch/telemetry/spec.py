"""TelemetrySpec — the static, hashable knob that turns tracing on.

The spec rides :class:`repro_torch.core.overlay.OverlayConfig`, so it is a
frozen, hashable dataclass whose fields fully determine the traced state
shapes (a batch needs one spec for all its configs). Turning any group on
adds integer trace leaves under ``state["telem"]``; ``telemetry=None`` adds
nothing, and the untraced state and cycle are those of a run without this
module. This is the port's own copy of the reference package's
``repro.telemetry.spec``, field for field.

Memory cost (int32, per simulation; the batched engine multiplies by the
config-batch size)::

    bucketed   buckets * nx * ny * 4 bytes  per bucketed leaf
               (pe: 2 leaves, links: 4, eject: 1, sched: 1)
    totals     nx * ny * 4 bytes            per total leaf
               (sched: 2, stalls: 3)

Per-cycle resolution is just ``bucket_cycles=1`` with ``buckets`` >= the
expected cycle count (:meth:`TelemetrySpec.per_cycle`); the default
64 x 32 bucketing covers 2048 cycles at ~100KB for a 16x16 grid, and
cycles past the horizon clamp into the last bucket so trace sums always
equal the scalar counters.
"""
from __future__ import annotations

import dataclasses

#: bucketed [buckets, nx, ny] leaves, by spec group.
BUCKETED_LEAVES = {
    "pe": ("pe_busy", "pe_occ"),
    "links": ("link_e", "link_s", "defl_noc", "defl_eject"),
    "eject": ("eject_grant",),
    "sched": ("ready_depth",),
}
#: per-PE total [nx, ny] leaves, by spec group.
TOTAL_LEAVES = {
    "sched": ("pick_pos", "picks"),
    "stalls": ("stall_no_ready", "stall_inject", "stall_sel_wait"),
}
GROUPS = ("pe", "links", "eject", "sched", "stalls")


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Which trace groups to record, and at what time resolution.

    ``buckets`` x ``bucket_cycles`` is the trace horizon in cycles; a cycle
    past it lands in the last bucket (clamped, never dropped). Groups:

      * ``pe``    — per-PE fires (``pe_busy``, sums to ``busy_cycles``) and
        fanout-drain occupancy (``pe_occ``) per bucket;
      * ``links`` — per-router E/S link utilization plus the deflection
        split by cause (``defl_noc`` sums to ``noc_deflections``,
        ``defl_eject`` to ``eject_deflections``);
      * ``eject`` — eject-port grants per router (sums to ``delivered``);
        the loser side of the contention is ``defl_eject``;
      * ``sched`` — ready-set depth per bucket (via the
        ``Scheduler.ready_depth`` protocol hook) + total pick count and
        summed pick slot position per PE;
      * ``stalls`` — per-PE stall attribution totals: idle with nothing
        ready, injection blocked by the NoC, pick serialized behind the
        exposed select latency.
    """

    buckets: int = 64
    bucket_cycles: int = 32
    pe: bool = True
    links: bool = True
    eject: bool = True
    sched: bool = True
    stalls: bool = True

    def __post_init__(self):
        if self.buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if self.bucket_cycles < 1:
            raise ValueError(
                f"bucket_cycles must be >= 1, got {self.bucket_cycles}")
        if not any(getattr(self, g) for g in GROUPS):
            raise ValueError(
                "TelemetrySpec with every trace group off records nothing; "
                "pass telemetry=None instead")

    @classmethod
    def per_cycle(cls, max_cycles: int, **groups) -> "TelemetrySpec":
        """Cycle-resolved spec: one bucket per cycle up to ``max_cycles``."""
        return cls(buckets=int(max_cycles), bucket_cycles=1, **groups)

    @property
    def horizon(self) -> int:
        """Cycles covered before clamping into the last bucket."""
        return self.buckets * self.bucket_cycles

    def leaf_names(self) -> tuple[str, ...]:
        """Trace-leaf names this spec records, bucketed first."""
        names = [n for g in GROUPS if getattr(self, g)
                 for n in BUCKETED_LEAVES.get(g, ())]
        names += [n for g in GROUPS if getattr(self, g)
                  for n in TOTAL_LEAVES.get(g, ())]
        return tuple(names)

    def memory_bytes(self, nx: int, ny: int) -> int:
        """int32 trace footprint for one simulation on an nx x ny grid."""
        n_bucketed = sum(len(BUCKETED_LEAVES.get(g, ()))
                         for g in GROUPS if getattr(self, g))
        n_total = sum(len(TOTAL_LEAVES.get(g, ()))
                      for g in GROUPS if getattr(self, g))
        return 4 * nx * ny * (self.buckets * n_bucketed + n_total)
