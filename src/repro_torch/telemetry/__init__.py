"""Cycle-resolved, bit-deterministic tracing of the overlay.

Per-PE occupancy, per-link Hoplite utilization, deflections by cause,
eject-port contention, scheduler ready-set depth and stall attribution,
recorded without perturbing the model. Opt in via::

    import repro_torch
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.telemetry import TelemetrySpec
    r = repro_torch.run(gm, OverlayConfig(telemetry=TelemetrySpec()))
    r.telemetry.report()                      # p50/p95 link util, stalls, ...
    r.telemetry.export_perfetto("trace.json") # open in ui.perfetto.dev

Traces accumulate as int32 tensors in the state (:mod:`.trace`) on every
engine of the port (``tensor``, ``select``, ``megakernel``, solo and
batched) and through the chunk repair, and are bit-identical across engines
and ``check_every`` values, and to the reference package's traces.
``telemetry=None`` (the default) leaves the untraced state and cycle as
they are. ``python -m repro_torch.telemetry`` runs the Fig. 1 graph with
tracing on and renders an ASCII heatmap and a Perfetto trace.
"""
from .result import TelemetryResult
from .spec import TelemetrySpec

__all__ = ["TelemetrySpec", "TelemetryResult"]
