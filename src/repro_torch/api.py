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
    """Simulate an overlay on one device, or with its PE grid tiled over a
    mesh of devices.

    Args:
      graph_or_gm: a packed :class:`repro_torch.core.partition.GraphMemory`,
        or a raw :class:`repro_torch.core.graph.DataflowGraph` plus
        ``nx``/``ny``, placed per ``cfg.placement`` (see
        :mod:`repro_torch.place`; a search runs on ``device`` too) with the
        memory layout the scheduler prefers.
      cfg: a :class:`repro_torch.core.overlay.OverlayConfig` (``None`` =
        defaults: ``ooo`` through the leading-one kernels). Its ``engine``
        is ``"select"`` (the leading-one kernels once per cycle),
        ``"tensor"`` (plain tensor ops) or ``"megakernel"`` (one kernel
        launch per ``check_every``-cycle chunk); all three give the same
        bits. Its ``telemetry`` (a
        :class:`repro_torch.telemetry.TelemetrySpec`) turns tracing on: the
        result's ``telemetry`` holds the traces, the same on every engine.
      mesh: a :class:`torch.distributed.device_mesh.DeviceMesh` with dims
        ``("data", "model")``: tiles the PE grid over the mesh's ranks
        (``nx`` divisible by the data axis, ``ny`` by the model axis; see
        :mod:`repro_torch.core.distributed`). Every rank of the mesh calls
        ``run`` with the same arguments and gets the same result; its tile
        lives on ``device`` (``None``: the rank's current CUDA device).
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
      ``repro.run`` on the same inputs, with or without a mesh.
    """
    from .core import distributed, overlay

    if batch is not None and cfg is not None:
        raise ValueError(
            "repro_torch.run: pass either cfg= (one config) or batch= "
            "(a config sweep), not both")
    device = resolve_device(device)
    if batch is not None:
        if mesh is not None:
            return distributed._simulate_batch_sharded(
                graph_or_gm, mesh, batch, nx=nx, ny=ny, device=device)
        return overlay._simulate_batch(graph_or_gm, batch, nx=nx, ny=ny,
                                       device=device)
    if mesh is not None:
        return distributed._simulate_sharded(graph_or_gm, mesh, cfg, nx=nx,
                                             ny=ny, device=device)
    return overlay._simulate(graph_or_gm, cfg, nx=nx, ny=ny, device=device)
