"""One run of one benchmark cell of the port (``repro_torch``).

A run: set-up (the graph from the frozen generator with values drawn from
the seed, the port's graph memory for each layout the cell's calls use,
one warm-up call of each kind), then a closed loop of solo calls to
``repro_torch.run`` for ``--seconds`` (``--trace 0``) or two profiled slices
of ``trace_calls`` calls each (``--trace 1``: device activity alone, then
host and device activity), then the comparison of what the calls returned
with the plain reference (:mod:`overlay_ref`), run once the window has
closed. The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared, with its limit.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own: ``configs/<name>.json`` (named by ``BENCHMARK.json``),
``traffic/<name>.json`` (read by :mod:`traffic`) and ``metrics/<name>.py``
(a ``read(ctx)`` that returns the metric's value, or None where the run has
nothing to read).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import arrow_lu, overlay_ref, traffic as traffic_mod

HERE = Path(__file__).resolve().parent
#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COUNTERS = overlay_ref.COUNTERS
#: The harness's own ranges in a traced slice: the slice, and each call.
ANNOTATIONS = ("bench_port.slice", "repro_torch.run")


@dataclasses.dataclass
class Call:
    """One call in the window: its kind, host wall and the cycles, done flag
    and counters it returned (``sim``; None and ``error`` if it raised)."""
    kind: int
    seconds: float
    sim: dict | None
    error: str | None = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_metric(name: str, metrics_dir: Path = HERE / "metrics"):
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def picks(struct: dict) -> int:
    """Nodes with a fanout: each is picked once a simulation."""
    return int(np.count_nonzero(np.diff(struct["fanout_ptr"])))


def packed_shapes(struct: dict, num_pes: int) -> dict:
    """Slots (padded to whole 32-flag words), words and edge records a PE
    of the round-robin placement: the shapes the port's kernels run at."""
    n = struct["opcode"].shape[0]
    pe = np.arange(n) % num_pes
    most = int(np.bincount(pe, minlength=num_pes).max())
    W = max(1, math.ceil(most / 32))
    fanout = np.diff(struct["fanout_ptr"])
    emax = max(1, int(np.bincount(pe, weights=fanout, minlength=num_pes).max()))
    return dict(L=32 * W, W=W, emax=emax)


class Cell:
    """A cell of the manifest: its entry, configuration, traffic mix and
    the metrics it reports."""

    def __init__(self, manifest: dict, workload: str, base: Path,
                 traffic_dir: Path):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        entry = {c["name"]: c for c in manifest["configs"]}[self.cell["config"]]
        with open(base / entry["file"]) as f:
            self.config = json.load(f)
        self.traffic = traffic_mod.load(traffic_dir
                                        / f"{self.cell['traffic']}.json")
        self.kinds = traffic_mod.kinds(self.traffic)
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]


def run(manifest: dict, workload: str, seed: int, seconds: float,
        trace: bool, *, base: Path, t_start: float, device=None,
        traffic_dir: Path = HERE / "traffic", out=None, err=None) -> int:
    """One run of ``workload``; prints the result line on ``out`` and the
    compared numbers on ``err``. ``device=None`` runs on the CUDA card
    (the caller has checked that the cell's chips are there); tests pass
    ``"cpu"``. Returns the exit code."""
    import torch

    import repro_torch
    from repro_torch.core.graph import DataflowGraph
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    out = out or sys.stdout
    err = err or sys.stderr
    cell = Cell(manifest, workload, base, traffic_dir)
    cfg, tr = cell.config, cell.traffic
    cuda = device is None
    t_import = time.perf_counter() - t_start
    t_device = time.perf_counter()
    if cuda:
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_device = time.perf_counter() - t_device

    # ---- set-up: the graph, the port's graph memories, one warm-up a kind
    t_graph = time.perf_counter()
    gen = cfg["graph"]
    struct = arrow_lu.structure(gen["blocks"], gen["block_size"],
                                gen["border"])
    values = arrow_lu.input_values(struct, seed)
    graph = DataflowGraph(opcode=struct["opcode"],
                          fanout_ptr=struct["fanout_ptr"],
                          fanout_dst=struct["fanout_dst"],
                          fanout_slot=struct["fanout_slot"],
                          initial_values=values)
    nx, ny = cfg["grid"]["nx"], cfg["grid"]["ny"]
    t_graph = time.perf_counter() - t_graph
    host_ir_s = 0.0
    memories = {}
    for layout in dict.fromkeys(k.layout for k in cell.kinds):
        t = time.perf_counter()
        memories[layout] = build_graph_memory(
            graph, nx, ny, placement=cfg["placement"],
            metric=cfg["criticality"],
            criticality_order=layout == "criticality")
        host_ir_s += time.perf_counter() - t

    def overlay_cfg(k):
        return OverlayConfig(scheduler=k.scheduler,
                             select_latency=k.select_latency,
                             engine=tr["engine"],
                             eject_policy=cfg["eject_policy"],
                             eject_capacity=cfg["eject_capacity"])

    invokes = [lambda gm=memories[k.layout], c=overlay_cfg(k):
               repro_torch.run(gm, c, device=device) for k in cell.kinds]
    t_warm = time.perf_counter()
    for invoke in invokes:
        invoke()
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter() - t_warm
    # What set-up made lives to the end: keep the collector from walking it
    # in the window.
    gc.collect()
    gc.freeze()

    # ---- the window: a closed loop of calls, or the traced slice
    order = traffic_mod.order(tr, len(cell.kinds), seed)
    sample = traffic_mod.Reservoir(int(tr.get("value_sample", 0)), seed)
    calls: list[Call] = []

    def one_call():
        k = next(order)
        t = time.perf_counter()
        try:
            r = invokes[k]()
            sim = dict(cycles=r.cycles, done=r.done,
                       **{c: getattr(r, c) for c in COUNTERS})
            error = None
        except Exception as e:  # a call that raises is a failed call
            r, sim, error = None, None, f"{type(e).__name__}: {e}"
        calls.append(Call(k, time.perf_counter() - t, sim, error))
        if r is not None:
            sample.offer(r.values)

    setup_s = time.perf_counter() - t_start
    profile = None
    t0 = time.perf_counter()
    if trace:
        profile = _traced(one_call, calls, int(tr["trace_calls"]), cuda)
    else:
        while time.perf_counter() - t0 < seconds:
            one_call()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    invokes.clear()
    memories.clear()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison with the plain reference
    t_ref = time.perf_counter()
    checks, failed, ref_cycles = _check(cell, struct, values, calls,
                                        sample.items, nx, ny)
    t_ref = time.perf_counter() - t_ref
    correct = bool(calls) and all(v <= lim for v, lim in checks.values())

    shapes = packed_shapes(struct, nx * ny)
    ctx = dict(cell=cell.cell, config=cfg, traffic=tr, kinds=cell.kinds,
               calls=calls, window_s=window_s, setup_s=setup_s,
               host_ir_setup_s=host_ir_s, nx=nx, ny=ny, shapes=shapes,
               picks=picks(struct),
               peaks=_peaks(),
               device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               profile=profile)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ctx["device_kind"],
           "count": int(cell.cell["chips"]) if cuda else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = profile["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 3
    print(f"calls {len(calls)}, window {window_s:.3f} s; set-up "
          f"{setup_s:.3f} s (imports {t_import:.3f}, device {t_device:.3f}, "
          f"graph {t_graph:.3f}, graph memories {host_ir_s:.3f}, warm-up "
          f"{t_warm:.3f}); reference {t_ref:.3f} s, its cycles {ref_cycles}",
          file=err)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


def _check(cell: Cell, struct: dict, values: np.ndarray, calls: list[Call],
           sampled: list, nx: int, ny: int):
    """Every call's cycles, done flag and counters against the reference's,
    and the node values of the sampled calls. Returns ({name: (value,
    limit)}, calls found wrong or failed, the reference's cycles by
    kind)."""
    prep = overlay_ref.prepare(struct)
    W = packed_shapes(struct, nx * ny)["W"]
    runs = [dict(scheduler=k.scheduler, layout=k.layout,
                 select_latency=(k.select_latency if k.select_latency
                                 is not None else
                                 W if k.scheduler == "scan" else 1))
            for k in cell.kinds]
    want = overlay_ref.simulate(struct, prep, nx, ny, runs,
                                eject_policy=cell.config["eject_policy"],
                                eject_capacity=cell.config["eject_capacity"])
    failed_calls = sum(c.error is not None for c in calls)
    wrong = sum(c.sim is not None and c.sim != want[c.kind] for c in calls)
    ref_values = overlay_ref.evaluate(struct, prep, values)
    bad_values = sum(int(np.count_nonzero(~(v == ref_values)))
                     for v in sampled)
    checks = {
        "calls_failed": (failed_calls, 0),
        "reference_unfinished": (sum(not r["done"] for r in want), 0),
        "sims_wrong": (wrong, 0),
        "values_wrong": (bad_values, 0),
    }
    cycles = {k.name: r["cycles"] for k, r in zip(cell.kinds, want)}
    return checks, wrong + failed_calls, cycles


def _peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def _traced(one_call, calls: list, n: int, cuda: bool) -> dict:
    """Two slices of ``n`` calls each under ``torch.profiler``. The first
    records device activity alone, so the profiler's host-side recording
    does not slow the calls: its device operations, their busy seconds (the
    union of their intervals), its length by the host's clock between two
    device synchronizations, and its calls are what the per-layer metrics
    read. The second records host and device activity and gives the
    breakdown's idle gaps by the host operation that was running; the
    breakdown's device operations (those that took most time) are the
    first's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    first = len(calls)
    with profile(activities=[ProfilerActivity.CUDA] if cuda
                 else [ProfilerActivity.CPU]) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one_call()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev = _events(prof, torch)[1] if cuda else []
    busy = _busy_and_gaps(dev, min((s for s, _, _ in dev), default=0),
                          max((s + d for s, d, _ in dev), default=0))[0]
    slice_calls = calls[first:]

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(ANNOTATIONS[0]):
            for _ in range(n):
                with record_function(ANNOTATIONS[1]):
                    one_call()
            if cuda:
                torch.cuda.synchronize()
    host, dev2 = _events(prof, torch)
    lo, hi = next((s, e) for s, e, name in host if name == ANNOTATIONS[0])
    dev2 = [d for d in dev2 if d[0] < hi and d[0] + d[1] > lo]
    gaps = _busy_and_gaps(dev2, lo, hi)[1]

    by_name: dict[str, float] = {}
    for _, d, name in dev:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=dev, busy_s=busy * 1e-9, window_s=window_s,
                calls=slice_calls,
                breakdown=dict(device_ops=[[k, v] for k, v in top],
                               idle_gaps=_gaps_by_host(gaps, host)))


def _events(prof, torch):
    """(host ranges as (start, end, name), device operations as (start,
    duration, name)) of a profile, in nanoseconds. The device-side span of
    a ``record_function`` range is no operation of the device."""
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((start, start + dur, e.name()))
        elif not e.is_user_annotation() and e.name() not in ANNOTATIONS:
            dev.append((start, dur, e.name()))
    return host, dev


def _busy_and_gaps(dev: list, lo: int, hi: int):
    """Union of the device intervals clipped to [lo, hi), and the idle gaps
    between them."""
    iv = sorted((max(s, lo), min(s + d, hi)) for s, d, _ in dev)
    busy, gaps, cur = 0, [], lo
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _gaps_by_host(gaps: list, host: list) -> list:
    """Idle seconds summed by the innermost host operation running at each
    gap's middle; the ten largest."""
    import bisect

    host = sorted(host)
    starts = [h[0] for h in host]
    total: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        name = "host (no operation)"
        for j in range(i - 1, max(-1, i - 512), -1):
            if host[j][1] >= mid and host[j][2] != ANNOTATIONS[0]:
                name = host[j][2]
                break
        total[name] = total.get(name, 0.0) + (e - s) * 1e-9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]
