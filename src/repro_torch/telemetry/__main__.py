"""Telemetry CLI: ``python -m repro_torch.telemetry [--smoke|--fig1]
[--out DIR] [--device cpu]``.

``--fig1`` (the default) runs the Fig. 1 graph ``arrow_lu_graph(4, 10, 8,
seed=3)`` (15,072 nodes, from the on-disk graph cache) on the 16x16 grid
with tracing on for ``ooo`` and ``inorder``, prints the ASCII PE-activity
heatmap and the stall-attribution report, and writes one Perfetto /
Chrome-trace JSON per policy under ``--out`` (default
``experiments/telemetry/``); load them at https://ui.perfetto.dev or
chrome://tracing.

``--smoke`` asserts the telemetry contract end to end on a small graph:
cycles unchanged with tracing on, traces summing to the scalar stat
counters, and the exported JSON reloading with the expected number of
counter tracks. Exits non-zero on any violation.

Both run on the CUDA card unless ``--device cpu`` is given (without a card
and without ``--device cpu`` the CLI raises).
"""
from __future__ import annotations

import json
import os
import sys
import time


def _trace_path(out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{name}.perfetto.json")


def smoke(out_dir: str, device=None) -> None:
    from repro_torch.api import run
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory
    from repro_torch.telemetry import TelemetrySpec
    from repro_torch.telemetry.perfetto import track_count

    g = wl.layered_dag(5, 8, seed=3)
    gm = build_graph_memory(g, 2, 2, criticality_order=True)
    spec = TelemetrySpec(buckets=16, bucket_cycles=8)
    for sched in ("ooo", "inorder"):
        base = run(gm, OverlayConfig(scheduler=sched), device=device)
        r = run(gm, OverlayConfig(scheduler=sched, telemetry=spec),
                device=device)
        tel = r.telemetry
        assert r.done and r.cycles == base.cycles, (sched, r.cycles, base.cycles)
        assert int(tel.traces["pe_busy"].sum()) == r.busy_cycles
        assert int(tel.traces["defl_noc"].sum()) == r.noc_deflections
        assert int(tel.traces["defl_eject"].sum()) == r.eject_deflections
        assert int(tel.traces["eject_grant"].sum()) == r.delivered
        assert r.noc_deflections + r.eject_deflections == r.deflections

        path = _trace_path(out_dir, f"smoke_{sched}")
        tel.export_perfetto(path)
        with open(path) as f:
            loaded = json.load(f)
        tracks = {(e["pid"], e["name"]) for e in loaded["traceEvents"]
                  if e["ph"] == "C"}
        assert len(tracks) == track_count(spec, 2, 2), (
            len(tracks), track_count(spec, 2, 2))
        rep = tel.report()
        assert rep["stalls"]["no_ready"] >= 0 and rep["links"]["busy_max"] > 0
        print(f"telemetry_smoke_{sched},0.0,{r.cycles}")
    print("TELEMETRY_SMOKE_OK")


def fig1(out_dir: str, device=None) -> list[str]:
    """Returns the paths of the Perfetto traces written."""
    from repro_torch.api import run
    from repro_torch.core import schedulers
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory
    from repro_torch.telemetry import TelemetrySpec

    name = wl.TELEMETRY_GRAPH
    g = wl.cached_graph(name, lambda: wl.arrow_lu_graph(4, 10, 8, seed=3))
    spec = TelemetrySpec()
    paths = []
    for sched in ("ooo", "inorder"):
        gm = build_graph_memory(
            g, 16, 16,
            criticality_order=schedulers.get(sched).wants_criticality_order)
        t0 = time.time()
        r = run(gm, OverlayConfig(scheduler=sched, max_cycles=8_000_000,
                                  telemetry=spec), device=device)
        assert r.done, sched
        path = _trace_path(out_dir, f"fig1_{name}_{sched}")
        r.telemetry.export_perfetto(path)
        rep = r.telemetry.report()
        print(f"\n=== {sched}: {r.cycles} cycles on {name} "
              f"({round(time.time() - t0, 1)}s) ===")
        print(r.telemetry.ascii_heatmap("pe_busy"))
        print(f"links: p50 util {rep['links']['util_p50']}, "
              f"p95 {rep['links']['util_p95']}, max {rep['links']['util_max']}"
              f"; hot: " + ", ".join(
                  f"{t['link']}={t['busy']}" for t in rep["links"]["top"][:3]))
        print(f"stalls: {rep['stalls']}")
        print(f"sched: {rep['sched']}")
        print(f"trace: {path}")
        paths.append(path)
    return paths


def main(argv: list[str]) -> int:
    out_dir = os.environ.get(
        "REPRO_TELEMETRY_DIR",
        os.path.join(os.getcwd(), "experiments", "telemetry"))
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    if "--smoke" in argv:
        smoke(out_dir, device)
        return 0
    known = {"--fig1", "--out", "--device"}
    if "--fig1" in argv or not [a for a in argv
                                if a.startswith("-") and a not in known]:
        fig1(out_dir, device)
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
