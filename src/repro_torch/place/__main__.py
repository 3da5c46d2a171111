"""Placement smoke: ``python -m repro_torch.place [--smoke] [--device cpu]``.

Runs the placement subsystem end to end on a small Fig. 1-family workload
(``arrow_lu_graph(2, 8, 6, seed=3)``, 3,689 nodes, 8x8) and asserts its
contracts:

  * identity placement through ``OverlayConfig(placement=...)`` is
    bit-identical to the direct ``build_graph_memory`` path;
  * the annealer is deterministic for a fixed key and never scores worse
    than its random init;
  * the annealed placement's simulated cycle count beats the random one.

Runs on the CUDA card (the anneal kernel, the default engine) unless
``--device cpu`` is given (without a card and without ``--device cpu`` it
raises). Prints one line of results; exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import sys
import time


def smoke(device=None) -> str:
    import numpy as np

    from repro_torch import place
    from repro_torch.api import run
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    g = wl.arrow_lu_graph(2, 8, 6, seed=3)
    nx = ny = 8
    acfg = place.AnnealConfig(replicas=6, rounds=12, steps=256, seed=0)

    # 1. identity == the direct path, bit-exact.
    legacy = run(build_graph_memory(g, nx, ny),
                 OverlayConfig(max_cycles=200_000), device=device)
    via_place = run(g, OverlayConfig(max_cycles=200_000,
                                     placement="identity"),
                    nx=nx, ny=ny, device=device)
    assert via_place.cycles == legacy.cycles, (via_place.cycles, legacy.cycles)
    np.testing.assert_array_equal(via_place.values, legacy.values)

    # 2. determinism + cost monotonicity vs the random init.
    t0 = time.perf_counter()
    r1 = place.anneal_placement(g, nx, ny, acfg, device=device)
    wall = time.perf_counter() - t0
    r2 = place.anneal_placement(g, nx, ny, acfg, device=device)
    np.testing.assert_array_equal(r1.node_pe, r2.node_pe)
    assert r1.cost <= r1.init_cost, (r1.cost, r1.init_cost)

    # 3. annealed beats random on simulated cycles.
    spec_rand = place.PlacementSpec(strategy="random", seed=acfg.seed)
    res = place.evaluate_placements(
        g, nx, ny, {"random": spec_rand, "annealed": r1.node_pe},
        cfgs=OverlayConfig(max_cycles=400_000), device=device)
    rand, ann = res["random"], res["annealed"]
    assert rand.done and ann.done
    assert ann.cycles < rand.cycles, (ann.cycles, rand.cycles)
    return (f"place smoke OK: identity={legacy.cycles} cycles, "
            f"anneal cost {r1.init_cost} -> {r1.cost} "
            f"({100 * r1.improvement:.1f}%, {wall:.2f} s), "
            f"cycles random={rand.cycles} annealed={ann.cycles}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.place",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the placement smoke (the default and only mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print(smoke(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
