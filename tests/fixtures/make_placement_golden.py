"""Write ``placement_golden.npz``: the reference annealer's placements of the
``BENCH_overlay.json`` placement rows and of its multilevel row, the goldens
the port's CPU tests simulate and ``chip_smoke.py`` holds the card's
searches to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_placement_golden.py

The reference package (``repro.place``) runs on the non-partitionable
Threefry layout (``jax_threefry_partitionable=False``), the layout the BENCH
goldens were recorded on; it imports ``enable_x64`` from ``jax.experimental``,
which newer jax lacks, so this script aliases it to ``jax.enable_x64`` first.
For each placement row (``benchmarks/placement_bench.py``'s
``PLACEMENT_WORKLOADS``: ``arrow_lu_graph(2, 8, 6, seed=3)`` on 8x8 and
``arrow_lu_graph(4, 8, 8, seed=3)`` on 16x16) it keeps the annealed
placement from the random init and from the round-robin init, with their
costs and init costs; for the multilevel row (``arrow_lu_graph(32, 10, 8,
seed=3)`` on 16x16, ``MULTILEVEL_COARSE``/``MULTILEVEL_REFINE``, ratio 32)
the final placement, the cluster count and the projected and refined costs.
It also keeps the n3689 search's costs on the partitionable layout (jax's
default), which differ. Takes ~40 s on the CPU.
"""
from __future__ import annotations

import time
from pathlib import Path

import jax
import jax.experimental

jax.experimental.enable_x64 = jax.enable_x64
jax.config.update("jax_threefry_partitionable", False)

import numpy as np  # noqa: E402

from repro import place  # noqa: E402
from repro.core import workloads as wl  # noqa: E402

OUT = Path(__file__).with_name("placement_golden.npz")

#: row -> (arrow_lu_graph args, grid, AnnealConfig keywords), as in
#: benchmarks/placement_bench.py.
ROWS = {
    "n3689": ((2, 8, 6), (8, 8), dict(replicas=8, rounds=32, steps=1024,
                                      seed=0)),
    "n10308": ((4, 8, 8), (16, 16), dict(replicas=8, rounds=64, steps=2048,
                                         seed=0)),
}
MULTILEVEL = ((32, 10, 8), (16, 16),
              dict(replicas=8, rounds=24, steps=2048, seed=0),
              dict(replicas=4, rounds=8, steps=2048, seed=0), 32)


def main() -> None:
    out = {}
    for name, (args, (nx, ny), kw) in ROWS.items():
        t = time.time()
        g = wl.arrow_lu_graph(*args, seed=3)
        acfg = place.AnnealConfig(**kw)
        ann = place.anneal_placement(g, nx, ny, acfg)
        ann_id = place.anneal_placement(
            g, nx, ny, acfg, init=place.resolve(g, nx, ny, "round_robin"))
        for tag, r in (("annealed", ann), ("annealed_identity", ann_id)):
            out[f"{name}/{tag}/node_pe"] = r.node_pe.astype(np.int32)
            out[f"{name}/{tag}/cost"] = np.int64(r.cost)
            out[f"{name}/{tag}/init_cost"] = np.int64(r.init_cost)
            out[f"{name}/{tag}/replica_costs"] = r.replica_costs
        print(f"{name}: costs {ann.init_cost} -> {ann.cost}, identity init "
              f"{ann_id.init_cost} -> {ann_id.cost} ({time.time() - t:.0f} s)",
              flush=True)
    # The same n3689 search on the partitionable layout (jax's default since
    # 0.5): another stream, so another placement and cost. Kept to show
    # which layout the goldens need.
    jax.config.update("jax_threefry_partitionable", True)
    args, (nx, ny), kw = ROWS["n3689"]
    r = place.anneal_placement(wl.arrow_lu_graph(*args, seed=3), nx, ny,
                               place.AnnealConfig(**kw))
    jax.config.update("jax_threefry_partitionable", False)
    out["n3689/partitionable/cost"] = np.int64(r.cost)
    out["n3689/partitionable/init_cost"] = np.int64(r.init_cost)
    print(f"n3689 on the partitionable layout: costs {r.init_cost} -> "
          f"{r.cost}", flush=True)
    args, (nx, ny), coarse, refine, ratio = MULTILEVEL
    t = time.time()
    g = wl.arrow_lu_graph(*args, seed=3)
    ml = place.multilevel_anneal(g, nx, ny, place.AnnealConfig(**coarse),
                                 ratio=ratio,
                                 refine=place.AnnealConfig(**refine))
    out["multilevel/node_pe"] = ml.node_pe.astype(np.int32)
    out["multilevel/num_clusters"] = np.int64(ml.num_clusters)
    out["multilevel/projected_cost"] = np.int64(ml.projected_cost)
    out["multilevel/cost"] = np.int64(ml.cost)
    out["multilevel/coarse_cost"] = np.int64(ml.coarse.cost)
    print(f"multilevel n{g.num_nodes}: {ml.num_clusters} clusters, costs "
          f"{ml.projected_cost} -> {ml.cost} ({time.time() - t:.0f} s)",
          flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
