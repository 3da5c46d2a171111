"""Chrome-trace / Perfetto JSON export of telemetry traces (numpy), the
reference package's ``repro.telemetry.perfetto`` ported as it is: the same
traces give the same JSON, the ``generator`` field included.

Emits the Trace Event Format (the JSON Perfetto UI and chrome://tracing
both load): one counter track (``"ph": "C"``) per PE, per link, per router
deflection/eject port, plus global wavefront and ready-depth tracks, with
one sample per time bucket. Timestamps are in "microseconds" 1:1 with
simulated cycles, so the UI's time axis reads directly as cycles.

Track inventory (distinct counter names; asserted in tests):

    pe    -> nx*ny  ``pe@x,y``       {busy, occupied}   + 1 ``wavefront``
    links -> 2*nx*ny ``link_{E,S}@x,y`` {busy}
             + nx*ny ``deflect@x,y``    {noc, eject}
    eject -> nx*ny  ``eject@x,y``    {grants}
    sched -> 1      ``ready_depth``  {total}
"""
from __future__ import annotations

import json


def track_count(spec, nx: int, ny: int) -> int:
    """Number of distinct counter tracks :func:`export` emits."""
    n = 0
    if spec.pe:
        n += nx * ny + 1          # pe@x,y + wavefront
    if spec.links:
        n += 3 * nx * ny          # link_E, link_S, deflect
    if spec.eject:
        n += nx * ny
    if spec.sched:
        n += 1                    # global ready_depth
    return n


def export(res, path: str | None = None) -> dict:
    """Build (and optionally write) the Chrome-trace JSON for ``res``."""
    spec = res.spec
    nx, ny = res.nx, res.ny
    used = res.used_buckets
    ev: list[dict] = []

    for pid, name in ((0, "PEs"), (1, "NoC links"), (2, "scheduler")):
        ev.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": f"overlay {name}"}})

    def counter(pid, name, b, args):
        ev.append({"ph": "C", "pid": pid, "tid": 0, "name": name,
                   "ts": b * spec.bucket_cycles, "args": args})

    t = res.traces
    wave = res.wavefront() if spec.pe else None
    for b in range(used):
        if spec.pe:
            counter(0, "wavefront", b, {"fired_cum": int(wave[b])})
        if spec.sched:
            counter(2, "ready_depth", b,
                    {"total": int(t["ready_depth"][b].sum())})
        for x in range(nx):
            for y in range(ny):
                if spec.pe:
                    counter(0, f"pe@{x},{y}", b,
                            {"busy": int(t["pe_busy"][b, x, y]),
                             "occupied": int(t["pe_occ"][b, x, y])})
                if spec.links:
                    counter(1, f"link_E@{x},{y}", b,
                            {"busy": int(t["link_e"][b, x, y])})
                    counter(1, f"link_S@{x},{y}", b,
                            {"busy": int(t["link_s"][b, x, y])})
                    counter(1, f"deflect@{x},{y}", b,
                            {"noc": int(t["defl_noc"][b, x, y]),
                             "eject": int(t["defl_eject"][b, x, y])})
                if spec.eject:
                    counter(1, f"eject@{x},{y}", b,
                            {"grants": int(t["eject_grant"][b, x, y])})

    trace = {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro.telemetry",
            "cycles": int(res.cycles),
            "grid": f"{nx}x{ny}",
            "bucket_cycles": spec.bucket_cycles,
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
