#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # everything, as the check runs it
    python3 chip_smoke.py --rows n15072  # only the smallest main-path row

Phases, each of which fails the run on any error:
  1. the card: its name and power limit from ``nvidia-smi``;
  2. build: compiles every CUDA source of the port with ``nvcc`` (set-up);
  3. kernels: each leading-one kernel against its plain torch version on the
     card, at the benchmark shapes and the main path's shapes, on edge-case
     inputs (words with the top bit set, empty rows, ``ptr`` at 0, 31, 32
     and W*32-1, gates all on, all off and mixed); equality must be exact.
     Then kernel and plain version are timed with CUDA events: device time
     per call (100 calls captured in a CUDA graph and replayed, median of 7
     replays) and latency per call from the host (median of 100 calls);
  4. main path: ``repro_torch.run`` with ``engine="select"`` on the 16x16
     PE grid for the Fig. 1 arrow-LU graphs; every cycle count must equal
     the reference's golden, values must match ``reference_evaluate``
     (rtol = atol = 1e-5, as the reference's own tests hold them), the
     n15072 results must equal a CPU run of the port bit for bit, and the
     scheduler kernels must have been launched during this phase.

A last phase traces the first 300 cycles of the n15072 ``ooo`` run with
``torch.profiler`` and prints the device busy share and the kernels that
take the device time.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside this file, the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12

#: Main-path rows: name -> (arrow_lu_graph args, {scheduler: golden cycles}).
#: The goldens are the reference package's cycle counts on the 16x16 grid.
ROWS = {
    "n15072": ((4, 10, 8, 3), {"ooo": 2125, "inorder": 2369}),
    "n29772": ((8, 10, 8, 3), {"ooo": 3974, "inorder": 4393,
                               "lru_flat": 4344, "scan": 4625}),
    "n117972": ((32, 10, 8, 3), {"ooo": 14213, "inorder": 17004}),
}

#: Row whose GPU results are also checked bit for bit against a CPU run.
CROSS_CHECK_ROW = "n15072"

#: Benchmark shapes of the reference's kernel bench, plus the main path's
#: RDY shapes on 16x16 (P = 256 rows, W = 2, 4 and 15 words).
KERNEL_SHAPES = [(256, 8), (256, 64), (256, 256), (1024, 64),
                 (256, 2), (256, 4), (256, 15)]
TIMED_SHAPE = (256, 15)   # the deepest main-path shape (n117,972)

KERNELS = {
    "lod": "src/repro/kernels/lod.py:109",
    "schedule_step": "src/repro/kernels/lod.py:130",
    "rotating_schedule_step": "src/repro/kernels/lod.py:167",
}
SOURCE = "src/repro_torch/kernels/csrc/lod.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def edge_inputs(torch, np, p, w, seed):
    """RDY words, pointers and three gates exercising the edge cases."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(p, w), dtype=np.uint32)
    bits[rng.random((p, w)) < 0.5] = 0
    bits[rng.random((p, w)) < 0.1] |= np.uint32(0x80000000)   # slot 0 of a word
    bits[rng.random((p, w)) < 0.1] = np.uint32(1)              # last slot of a word
    bits[0] = 0                                                # empty rows
    bits[p // 2] = 0
    bits[1] = 0
    bits[1, -1] = 1                                            # only the last slot
    ptr = rng.integers(0, w * 32, size=p).astype(np.int32)
    ptr[:8] = [0, 31, 32 % (w * 32), w * 32 - 1, 0, 31, 32 % (w * 32), w * 32 - 1]
    gates = {
        "all_on": np.ones(p, bool),
        "all_off": np.zeros(p, bool),
        "mixed": rng.random(p) < 0.5,
    }
    dev = "cuda"
    return (torch.from_numpy(bits.view(np.int32)).to(dev),
            torch.from_numpy(ptr).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in gates.items()})


def max_abs_err(torch, got, want):
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


def check_kernels(torch, np, lod):
    """Every kernel against its plain version; returns the largest error."""
    err = {k: 0 for k in KERNELS}
    for i, (p, w) in enumerate(KERNEL_SHAPES):
        bits, ptr, gates = edge_inputs(torch, np, p, w, seed=100 + i)
        pairs = [("lod", (lod.lod(bits),), (lod.lod_plain(bits),))]
        for g in (None, *gates.values()):
            pairs.append(("schedule_step", lod.schedule_step(bits, g),
                          lod.schedule_step_plain(bits, g)))
            pairs.append(("rotating_schedule_step",
                          lod.rotating_schedule_step(bits, ptr, g),
                          lod.rotating_schedule_step_plain(bits, ptr, g)))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            e = max_abs_err(torch, got, want)
            err[name] = max(err[name], e)
            if e != 0:
                raise AssertionError(
                    f"{name} differs from its plain version at {p}x{w}: "
                    f"max abs error {e}")
    return err


def call_ms(torch, fn, reps=100, warmup=10):
    """Median of ``reps`` single-call CUDA-event timings, in ms: the latency
    of one call from the host, launch overhead included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps=100, rounds=7):
    """Device time of one call, in ms: ``reps`` calls captured in a CUDA
    graph, replayed back to back; the median over ``rounds`` replays of the
    replay time divided by ``reps``. Host launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_times(torch, np, lod, p, w):
    """Per kernel at [p, w]: device ms and call ms of the kernel and of its
    plain version, and the bytes the function must move."""
    bits, ptr, gates = edge_inputs(torch, np, p, w, seed=7)
    gate = gates["mixed"]
    words = 4 * p * w
    calls = {
        # bytes: each input read once, each output written once
        "lod": (lambda: lod.lod(bits), lambda: lod.lod_plain(bits),
                words + 4 * p),
        "schedule_step": (lambda: lod.schedule_step(bits, gate),
                          lambda: lod.schedule_step_plain(bits, gate),
                          words + p + 4 * p + words),
        "rotating_schedule_step": (
            lambda: lod.rotating_schedule_step(bits, ptr, gate),
            lambda: lod.rotating_schedule_step_plain(bits, ptr, gate),
            words + 4 * p + p + 4 * p + words),
    }
    return {name: dict(ms=device_ms(torch, k), plain_ms=device_ms(torch, plain),
                       call_ms=call_ms(torch, k),
                       plain_call_ms=call_ms(torch, plain), bytes=nbytes)
            for name, (k, plain, nbytes) in calls.items()}


def main_path(torch, np, rows, lod):
    import repro_torch
    from repro_torch.core import workloads as wl
    from repro_torch.core.graph import reference_evaluate
    from repro_torch.core.overlay import OverlayConfig

    graphs = {}
    for name in rows:
        args, _ = ROWS[name]
        t = time.perf_counter()
        g = wl.arrow_lu_graph(*args[:3], seed=args[3])
        graphs[name] = (g, reference_evaluate(g))
        print(f"set-up {name}: arrow_lu_graph{args} -> {g.num_nodes} nodes, "
              f"{time.perf_counter() - t:.1f} s", flush=True)

    lod.reset_launches()
    for name in rows:
        g, ref = graphs[name]
        for sched, golden in ROWS[name][1].items():
            cfg = OverlayConfig(scheduler=sched, engine="select")
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = repro_torch.run(g, cfg, nx=16, ny=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ok_vals = bool(np.isfinite(r.values).all()) and bool(
                np.allclose(r.values, ref, rtol=1e-5, atol=1e-5))
            print(f"main path {name} {sched}: cycles {r.cycles} (golden "
                  f"{golden}), done {r.done}, deflections {r.deflections}, "
                  f"wall {wall:.2f} s, {r.cycles / wall:.0f} cycles/s",
                  flush=True)
            if not (r.done and r.cycles == golden and ok_vals):
                raise AssertionError(
                    f"main path {name} {sched}: cycles {r.cycles} vs golden "
                    f"{golden}, done {r.done}, values match {ok_vals}")
            if name == CROSS_CHECK_ROW:
                # The same run on the CPU (plain versions in place of the
                # kernels) must give the same bits: counters and values.
                c = repro_torch.run(g, cfg, nx=16, ny=16, device="cpu")
                same = (c.cycles, c.deflections, c.busy_cycles) == (
                    r.cycles, r.deflections, r.busy_cycles) and np.array_equal(
                    c.values, r.values)
                print(f"main path {name} {sched}: CPU run bit-identical {same}",
                      flush=True)
                if not same:
                    raise AssertionError(f"{name} {sched}: GPU and CPU differ")
    counts = dict(lod.launches)
    print(f"main path kernel launches: {counts}", flush=True)
    for name in ("schedule_step", "rotating_schedule_step"):
        wanted = any(sched in ROWS[r][1] for r in rows for sched in
                     (("ooo",) if name == "schedule_step"
                      else ("scan", "lru_flat")))
        if wanted and counts[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    return counts


def profile_main_path(torch, cycles=300):
    """Device busy share and top kernels over the first ``cycles`` cycles of
    the n15072 ``ooo`` run (a prefix: the run stops at ``max_cycles``)."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    args, _ = ROWS["n15072"]
    gm = build_graph_memory(wl.arrow_lu_graph(*args[:3], seed=args[3]), 16, 16)
    cfg = OverlayConfig(scheduler="ooo", engine="select", max_cycles=cycles)
    repro_torch.run(gm, cfg)   # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    repro_torch.run(gm, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        repro_torch.run(gm, cfg)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    # Device-side events only: the kernels (and copies) that ran on the card.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profile n15072 ooo, {cycles} cycles: wall {wall * 1e3:.1f} ms "
          f"untraced ({wall / cycles * 1e3:.3f} ms/cycle), "
          f"{traced_wall * 1e3:.1f} ms traced; device busy "
          f"{device_us / 1e3:.2f} ms = {device_us / (wall * 1e6):.4f} of the "
          f"untraced wall; {launches} device ops ({launches / cycles:.1f}/cycle)",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x  "
              f"{e.key[:100]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", nargs="+", default=list(ROWS), choices=list(ROWS),
                    help="main-path rows to run (default: all)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, lod

    print(card_line(), flush=True)   # name, power limit as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t = time.perf_counter()
    _build.library(lod.SOURCE)
    print(f"build: {lod.SOURCE} in {time.perf_counter() - t:.1f} s", flush=True)
    print(_build.build_logs.get(lod.SOURCE, "(library already built)").strip(),
          flush=True)

    err = check_kernels(torch, np, lod)
    print(f"kernels equal their plain versions at {KERNEL_SHAPES}", flush=True)
    timed = {}
    for p, w in KERNEL_SHAPES:
        timed[(p, w)] = kernel_times(torch, np, lod, p, w)
        for name, t in timed[(p, w)].items():
            print(f"kernel time {name} {p}x{w}: device {t['ms'] * 1e3:.2f} us "
                  f"(plain {t['plain_ms'] * 1e3:.2f} us), per call "
                  f"{t['call_ms'] * 1e3:.2f} us (plain "
                  f"{t['plain_call_ms'] * 1e3:.2f} us), bytes bound "
                  f"{t['bytes'] / HBM_BYTES_PER_S * 1e6:.4f} us", flush=True)

    counts = main_path(torch, np, args.rows, lod)
    profile_main_path(torch)

    line = []
    for name, replaces in KERNELS.items():
        t = timed[TIMED_SHAPE][name]
        line.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=counts[name], max_abs_err=err[name],
            equal=err[name] == 0, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None, call_ms=t["call_ms"],
            shape=list(TIMED_SHAPE)))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
