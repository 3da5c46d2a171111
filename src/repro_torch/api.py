"""repro_torch.run — the front door for overlay simulation on a torch device."""
from __future__ import annotations

from typing import Any, Sequence

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; with no card present that raises (the
    port never falls back to the CPU on its own). Pass ``device="cpu"`` to
    run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def run(graph_or_gm, cfg=None, *, mesh=None, batch: Sequence | None = None,
        nx: int | None = None, ny: int | None = None, device=None) -> Any:
    """Simulate an overlay on one device.

    Args:
      graph_or_gm: a packed :class:`repro_torch.core.partition.GraphMemory`,
        or a raw :class:`repro_torch.core.graph.DataflowGraph` plus
        ``nx``/``ny`` (identity placement, with the memory layout the
        scheduler prefers).
      cfg: a :class:`repro_torch.core.overlay.OverlayConfig` (``None`` =
        defaults: ``ooo`` through the leading-one kernels). Its ``engine``
        is ``"select"`` (the leading-one kernels once per cycle),
        ``"tensor"`` (plain tensor ops) or ``"megakernel"`` (one kernel
        launch per ``check_every``-cycle chunk); all three give the same
        bits. Its ``telemetry`` (a
        :class:`repro_torch.telemetry.TelemetrySpec`) turns tracing on: the
        result's ``telemetry`` holds the traces, the same on every engine.
      mesh: the sharded engines (and their telemetry); not ported yet.
      batch: a sequence of configs to sweep as one batch over the same graph
        (mutually exclusive with ``cfg``). They must share ``eject_capacity``,
        ``eject_policy``, ``engine``, ``placement`` and ``telemetry`` (each
        element's traces equal its solo run's); under
        ``engine="megakernel"`` each chunk is one launch of the kernel with
        one CTA per config.
      nx, ny: PE grid, required only with a raw ``DataflowGraph``.
      device: torch device; ``None`` = the CUDA card (raises without one).

    Returns:
      :class:`repro_torch.core.overlay.SimResult` (a list of them, one per
      config, with ``batch=``), equal bit for bit to the reference package's
      ``repro.run`` on the same inputs.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the sharded engines) is not ported yet "
            "(ROADMAP queue 1, item 8)")
    from .core import overlay

    if batch is not None:
        if cfg is not None:
            raise ValueError(
                "repro_torch.run: pass either cfg= (one config) or batch= "
                "(a config sweep), not both")
        return overlay._simulate_batch(graph_or_gm, batch, nx=nx, ny=ny,
                                       device=resolve_device(device))
    return overlay._simulate(graph_or_gm, cfg, nx=nx, ny=ny,
                             device=resolve_device(device))
