"""Service CLI: ``python -m repro_torch.service [--smoke] [--device cpu]``.

Default mode replays the deterministic ``workloads.service_stream`` through
a fresh :class:`~repro_torch.service.service.PlacementService` and prints
the amortization story: per-query hit/miss, then the cache + execution
counters.

``--smoke`` runs the reference smoke's three checks on a small stream:

  * repeat queries answer from the content-hash cache with ZERO additional
    simulations and bit-exact cycles (counter-asserted);
  * a batched multi-query anneal fan-out returns row-for-row the same
    placements and cycle counts as solo queries;
  * the design-space explorer's Pareto frontier is deterministic under
    replay.

Runs on the CUDA card unless ``--device cpu`` is given (without a card and
without ``--device cpu`` it raises). Prints ``SERVICE_SMOKE_OK``; exits
non-zero on any violation.
"""
from __future__ import annotations

import argparse
import sys


def _check(ok: bool, msg) -> None:
    if not ok:
        raise AssertionError(msg)


def smoke(device=None) -> None:
    import numpy as np

    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.place import PlacementSpec
    from repro_torch.service import PlacementQuery, PlacementService, explore

    cfg = OverlayConfig(placement="anneal", max_cycles=200_000)
    stream = wl.service_stream(n_queries=8, distinct=3, seed=0)

    # 1. Repeats are free: zero extra simulations, bit-exact integers.
    svc = PlacementService(device=device)
    answers = {}
    for name, g in stream:
        sims_before = svc.counters["simulations"]
        r = svc.query(PlacementQuery(graph=g, nx=4, ny=4, budget=2048,
                                     cfg=cfg))
        if name in answers:
            first = answers[name]
            _check(r.cached, f"{name}: repeat missed the cache")
            _check(svc.counters["simulations"] == sims_before,
                   f"{name}: cache hit ran a simulation")
            _check(r.cycles == first.cycles, (name, r.cycles, first.cycles))
            _check(np.array_equal(r.node_pe, first.node_pe), name)
            _check(r.stats == first.stats, name)
        else:
            _check(not r.cached and r.cycles is not None, name)
            answers[name] = r
    rep = svc.report()
    _check(rep["cache_hits"] == len(stream) - len(answers), rep)
    _check(rep["simulations"] == len(answers), rep)
    print(f"service_smoke_stream,0.0,hit_rate={rep['cache_hit_rate']}")

    # 2. Batched anneal fan-out == solo queries, row for row.
    g = stream[0][1]
    seeds = (0, 1, 2)
    mk = lambda s: PlacementQuery(
        graph=g, nx=4, ny=4, budget=2048,
        cfg=OverlayConfig(placement=PlacementSpec(strategy="anneal", seed=s),
                          max_cycles=200_000))
    batch_svc = PlacementService(device=device)
    batched = batch_svc.run_batch([mk(s) for s in seeds])
    _check(batch_svc.counters["batched_anneals"] == len(seeds),
           batch_svc.counters)
    solo = [PlacementService(device=device).query(mk(s)) for s in seeds]
    for s, b, r in zip(seeds, batched, solo):
        _check(np.array_equal(b.node_pe, r.node_pe), f"seed {s}")
        _check(b.cycles == r.cycles, (s, b.cycles, r.cycles))
    print(f"service_smoke_batch,0.0,rows={len(seeds)}")

    # 3. Frontier determinism under replay.
    space = {"grid": ((2, 2), (4, 4)), "placement": ("identity", "anneal")}
    rec1 = explore(g, space=space, budget=2048, max_cycles=200_000,
                   device=device)
    rec2 = explore(g, space=space, budget=2048, max_cycles=200_000,
                   device=device)
    _check(rec1["frontier"] == rec2["frontier"], "frontier not deterministic")
    _check(rec1["points"] == rec2["points"], "points not deterministic")
    front = ",".join(f"{p['name']}={p['cycles']}" for p in rec1["frontier"])
    print(f"service_smoke_frontier,0.0,{front}")
    print("SERVICE_SMOKE_OK")


def demo(device=None) -> None:
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.workloads import service_stream
    from repro_torch.service import PlacementQuery, PlacementService

    svc = PlacementService(device=device)
    cfg = OverlayConfig(placement="anneal", max_cycles=1_000_000)
    for name, g in service_stream(n_queries=16, distinct=4, seed=0):
        r = svc.query(PlacementQuery(graph=g, nx=4, ny=4, budget=4096,
                                     cfg=cfg))
        tag = "hit " if r.cached else "miss"
        print(f"{tag} {name}: {r.cycles} cycles (key {r.key:#x})")
    for k, v in sorted(svc.report().items()):
        print(f"  {k} = {v}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the service smoke (default: the stream demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        smoke(args.device)
    else:
        demo(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
