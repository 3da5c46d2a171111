"""Host-side telemetry container: numpy traces + report/export helpers."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .spec import TelemetrySpec

#: glyph ramp for the ASCII heatmap, dimmest to hottest.
_RAMP = " .:-=+*#%@"


@dataclasses.dataclass
class TelemetryResult:
    """Traces of ONE simulation, unpacked to numpy by ``SimResult``.

    ``traces`` maps leaf name (see :mod:`repro_torch.telemetry.trace`) to an int32
    array — ``[buckets, nx, ny]`` for bucketed traces, ``[nx, ny]`` for
    per-PE totals. ``cycles`` is the simulated cycle count, which bounds the
    buckets that actually saw traffic."""

    spec: TelemetrySpec
    traces: dict[str, np.ndarray]
    cycles: int
    nx: int
    ny: int

    @property
    def used_buckets(self) -> int:
        """Buckets covering the simulated cycle range (>= 1)."""
        return max(1, min(self.spec.buckets,
                          math.ceil(self.cycles / self.spec.bucket_cycles)))

    def wavefront(self) -> np.ndarray:
        """[used_buckets] cumulative node fires — the wavefront-progress
        curve (requires the ``pe`` trace group)."""
        fires = self.traces["pe_busy"].sum(axis=(-2, -1))
        return np.cumsum(fires)[: self.used_buckets]

    def report(self, top_k: int = 5) -> dict:
        """Structured summary: p50/p95/max link utilization, top-k hot
        links, stall-cycle attribution. See
        :func:`repro_torch.telemetry.report.build_report` for the schema."""
        from .report import build_report

        return build_report(self, top_k=top_k)

    def export_perfetto(self, path: str | None = None) -> dict:
        """Chrome-trace/Perfetto JSON (counter tracks per PE / link /
        router); written to ``path`` when given, returned either way."""
        from .perfetto import export

        return export(self, path=path)

    def ascii_heatmap(self, leaf: str = "pe_busy") -> str:
        """Terminal heatmap of a trace leaf summed over time (x down,
        y across) — the CLI's at-a-glance hot-spot view."""
        a = self.traces[leaf]
        grid = a.sum(axis=0) if a.ndim == 3 else a
        peak = int(grid.max())
        lines = [f"{leaf} per PE (peak {peak}, {self.nx}x{self.ny} grid)"]
        for x in range(self.nx):
            row = ""
            for y in range(self.ny):
                lvl = 0 if peak == 0 else int(
                    grid[x, y] * (len(_RAMP) - 1) / peak)
                row += _RAMP[lvl] * 2
            lines.append(row)
        return "\n".join(lines)
