"""Megakernel smoke: ``python -m repro_torch.kernels --smoke [--device cpu]``.

A fast end-to-end check of the one-launch chunk engine: for every
registered scheduler policy on ``layered_dag(4, 6, seed=3)`` (2x2), the
``engine="megakernel"`` run must equal the ``engine="tensor"`` run at
``check_every=1`` (stats AND node values), and on the card one chunk must
be exactly one kernel launch (``megakernel.launches["mega_chunk"]``). Then
one Fig. 1-family graph (n15072, from the on-disk graph cache that
``python -m repro_torch.core.workloads megakernel_bench`` fills) must give
its golden cycle counts, 2125 (``ooo``) and 2369 (``inorder``) on 16x16,
under ``engine="megakernel"`` and the default engine alike. Prints
``MEGAKERNEL_SMOKE_OK``; exits non-zero on any mismatch.

``--fig1`` alone skips the small matrix and runs only the Fig. 1 check.
Runs on the CUDA card unless ``--device cpu`` is given (there the
megakernel engine runs its plain chunk, so no launch is counted).
"""
from __future__ import annotations

import argparse
import sys
import time

#: The Fig. 1 row's golden cycle counts on 16x16 (the reference's).
FIG1_GOLDENS = {"ooo": 2125, "inorder": 2369}


def _stats(r):
    return (r.done, r.cycles, r.deflections, r.busy_cycles, r.delivered)


def _check(ok: bool, msg) -> None:
    if not ok:
        raise AssertionError(msg)


def matrix(device=None) -> dict:
    """Every policy on ``layered_dag(4, 6, seed=3)`` (2x2): megakernel
    (``check_every=8``) equal to the tensor engine at ``check_every=1``, and
    on the card one ``mega_chunk`` launch per chunk. Returns ``{policy:
    the megakernel run's SimResult}``."""
    import numpy as np
    import torch

    from repro_torch import run
    from repro_torch.api import resolve_device
    from repro_torch.core import schedulers
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import (OverlayConfig, device_graph,
                                          init_state, make_engine_chunk_fn)
    from repro_torch.core.partition import build_graph_memory
    from repro_torch.kernels import megakernel as mk

    dev = resolve_device(device)
    g = wl.layered_dag(4, 6, seed=3)
    out = {}
    for sched in sorted(schedulers.REGISTRY):
        gm = build_graph_memory(
            g, 2, 2,
            criticality_order=schedulers.get(sched).wants_criticality_order)
        ref = run(gm, OverlayConfig(scheduler=sched, check_every=1,
                                    engine="tensor"), device=dev)
        r = run(gm, OverlayConfig(scheduler=sched, check_every=8,
                                  engine="megakernel"), device=dev)
        _check(_stats(r) == _stats(ref), (sched, _stats(r), _stats(ref)))
        np.testing.assert_array_equal(r.values, ref.values)

        cfg = OverlayConfig(scheduler=sched, engine="megakernel")
        dg = device_graph(gm, dev)
        chunk = make_engine_chunk_fn(dg, cfg, 8)
        mk.reset_launches()
        chunk(init_state(dg, cfg))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            _check(mk.launches["mega_chunk"] == 1,
                   (sched, "one chunk is not one launch", dict(mk.launches)))
        print(f"megakernel_smoke_{sched},0.0,{r.cycles}")
        out[sched] = r
    return out


def fig1(device=None) -> dict:
    """n15072 (the graph cache's ``arrow_b4_s10_w8_seed3``) on 16x16 under
    the megakernel and the default engine: equal, at the goldens. Returns
    ``{policy: cycles}``."""
    import numpy as np

    from repro_torch import run
    from repro_torch.api import resolve_device
    from repro_torch.core import schedulers
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    dev = resolve_device(device)
    name = wl.MEGAKERNEL_BENCH_GRAPHS[0]
    g = wl.cached_graph(name, lambda: wl.arrow_lu_graph(4, 10, 8, seed=3))
    out = {}
    for sched, golden in FIG1_GOLDENS.items():
        gm = build_graph_memory(
            g, 16, 16,
            criticality_order=schedulers.get(sched).wants_criticality_order)
        t0 = time.time()
        ref = run(gm, OverlayConfig(scheduler=sched, max_cycles=8_000_000),
                  device=dev)
        r = run(gm, OverlayConfig(scheduler=sched, max_cycles=8_000_000,
                                  engine="megakernel"), device=dev)
        _check(r.done and _stats(r) == _stats(ref),
               (sched, _stats(r), _stats(ref)))
        _check(r.cycles == golden, (sched, r.cycles, golden))
        np.testing.assert_array_equal(r.values, ref.values)
        print(f"megakernel_smoke_fig1_{sched},"
              f"{round(1e6 * (time.time() - t0), 1)},{r.cycles}")
        out[sched] = r.cycles
    return out


def smoke(fig1_only: bool = False, device=None) -> None:
    if not fig1_only:
        matrix(device)
    fig1(device)
    print("MEGAKERNEL_SMOKE_OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the matrix and the Fig. 1 check")
    ap.add_argument("--fig1", action="store_true",
                    help="the Fig. 1 check alone")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not (args.smoke or args.fig1):
        print(__doc__)
        return 2
    smoke(fig1_only=not args.smoke, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
