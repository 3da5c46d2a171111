"""Structured telemetry summaries (numpy), the reference package's
``repro.telemetry.report`` ported as it is: the same traces give the same
dict, key for key.

Every count in the report is an exact integer taken from the bit-
deterministic traces (the BENCH ``telemetry`` section's ``ctr_*`` values);
utilization ratios are derived floats. Sections appear only when the
corresponding :class:`~repro_torch.telemetry.spec.TelemetrySpec` group was
on.
"""
from __future__ import annotations

import numpy as np


def _link_rows(res) -> list[tuple[str, int]]:
    """(label, busy-cycles) for every E and S link, by router coordinate."""
    rows = []
    for leaf, tag in (("link_e", "E"), ("link_s", "S")):
        busy = res.traces[leaf].sum(axis=0)
        for x in range(res.nx):
            for y in range(res.ny):
                rows.append((f"{tag}@{x},{y}", int(busy[x, y])))
    return rows


def build_report(res, top_k: int = 5) -> dict:
    """Summary dict for one simulation's traces.

    Schema (sections keyed by enabled spec groups)::

        cycles, grid
        links:  busy_max, util_p50, util_p95, util_max, top[k],
                defl_noc, defl_eject
        pe:     busy_total, busy_max, occ_total, util_mean
        sched:  picks, pick_pos_mean, ready_depth_mean
        stalls: no_ready, inject_blocked, select_wait, eject_deflected
    """
    cycles = max(1, int(res.cycles))
    rep: dict = {"cycles": int(res.cycles), "grid": [res.nx, res.ny]}

    if "link_e" in res.traces:
        rows = _link_rows(res)
        busy = np.array([b for _, b in rows], dtype=np.int64)
        util = busy / cycles
        hot = sorted(rows, key=lambda r: (-r[1], r[0]))[:top_k]
        rep["links"] = {
            "busy_max": int(busy.max()),
            "util_p50": round(float(np.percentile(util, 50)), 4),
            "util_p95": round(float(np.percentile(util, 95)), 4),
            "util_max": round(float(util.max()), 4),
            "top": [{"link": label, "busy": b,
                     "util": round(b / cycles, 4)} for label, b in hot],
            "defl_noc": int(res.traces["defl_noc"].sum()),
            "defl_eject": int(res.traces["defl_eject"].sum()),
        }
    if "pe_busy" in res.traces:
        busy = res.traces["pe_busy"].sum(axis=0)
        rep["pe"] = {
            "busy_total": int(busy.sum()),
            "busy_max": int(busy.max()),
            "occ_total": int(res.traces["pe_occ"].sum()),
            "util_mean": round(float(busy.mean()) / cycles, 4),
        }
    if "picks" in res.traces:
        picks = int(res.traces["picks"].sum())
        rep["sched"] = {
            "picks": picks,
            # Mean slot index of committed picks: with criticality-ordered
            # memory, lower == the scheduler is finding critical work.
            "pick_pos_mean": round(
                int(res.traces["pick_pos"].sum()) / max(1, picks), 2),
            "ready_depth_mean": round(
                int(res.traces["ready_depth"].sum())
                / (cycles * res.nx * res.ny), 3),
        }
    if "stall_no_ready" in res.traces:
        rep["stalls"] = {
            # Per-PE-cycle attribution of why work didn't advance:
            "no_ready": int(res.traces["stall_no_ready"].sum()),
            "inject_blocked": int(res.traces["stall_inject"].sum()),
            "select_wait": int(res.traces["stall_sel_wait"].sum()),
            # eject losers circulate the ring — the NoC-side stall.
            "eject_deflected": int(res.traces["defl_eject"].sum())
            if "defl_eject" in res.traces else None,
        }
    return rep
