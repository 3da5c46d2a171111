"""Write ``surrogate_golden.npz``: the reference surrogate's BENCH rows
(``surrogate`` and ``guided``), the goldens the port's CPU tests check its
features and fit against and ``chip_smoke.py`` holds the card's rows to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_surrogate_golden.py

The reference package runs on the non-partitionable Threefry layout
(``jax_threefry_partitionable=False``), the layout the BENCH goldens were
recorded on; it imports ``enable_x64`` from ``jax.experimental``, which newer
jax lacks, so this script aliases it to ``jax.enable_x64`` first. For each
row of ``benchmarks/placement_bench.py`` (``arrow_lu_graph(2, 8, 6,
seed=3)`` on 8x8 and ``arrow_lu_graph(4, 8, 8, seed=3)`` on 16x16, under
``OverlayConfig(scheduler="ooo", max_cycles=4_000_000)``) it keeps, under
``<row>/``:

  * ``train/node_pe`` [48, N] and ``train/cycles`` [48]: ``fit_from_sim``'s
    training set (seed 0);
  * ``train/features`` [48, 29], ``mu``, ``sigma``, ``beta``, ``y_mean`` and
    ``gamma_q`` (``build_guide``): the fit;
  * ``held/node_pe`` [64, N], ``held/cycles`` [64] and ``held/pred`` [64]:
    the held-out set (seed 101, no static rows), its simulated cycles and
    the model's predictions;
  * ``guided/node_pe``, ``cost``, ``init_cost``, ``replica_costs``,
    ``cost_evals``, ``proposals``: the guided search at twice the
    placement row's rounds, margin 0.0.

Placements are stored as uint8 (every PE id of these grids is below 256).
Takes several minutes on the CPU (the 224 simulations dominate).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.experimental

jax.experimental.enable_x64 = jax.enable_x64
jax.config.update("jax_threefry_partitionable", False)

import numpy as np  # noqa: E402

from repro import place, surrogate  # noqa: E402
from repro.core import workloads as wl  # noqa: E402
from repro.core.overlay import OverlayConfig  # noqa: E402
from repro.surrogate import delta as sd  # noqa: E402

OUT = Path(__file__).with_name("surrogate_golden.npz")

#: row -> (arrow_lu_graph args, grid, the placement row's AnnealConfig
#: keywords), as in benchmarks/placement_bench.py.
ROWS = {
    "n3689": ((2, 8, 6), (8, 8), dict(replicas=8, rounds=32, steps=1024,
                                      seed=0)),
    "n10308": ((4, 8, 8), (16, 16), dict(replicas=8, rounds=64, steps=2048,
                                         seed=0)),
}
N_TRAIN, N_HELD, HELD_SEED = 48, 64, 101
GUIDED_ROUNDS_SCALE, GUIDED_MARGIN = 2, 0.0


def main() -> None:
    cfg = OverlayConfig(scheduler="ooo", max_cycles=4_000_000)
    out = {}
    for name, (args, (nx, ny), kw) in ROWS.items():
        t = time.time()
        g = wl.arrow_lu_graph(*args, seed=3)
        model, train, train_cycles = surrogate.fit_from_sim(
            g, nx, ny, cfg=cfg, n_train=N_TRAIN, seed=0)
        out[f"{name}/train/node_pe"] = np.asarray(train).astype(np.uint8)
        out[f"{name}/train/cycles"] = np.asarray(train_cycles, np.int64)
        out[f"{name}/train/features"] = model.extractor.features_batch(train)
        for k in ("mu", "sigma", "beta"):
            out[f"{name}/{k}"] = np.asarray(getattr(model, k), np.float64)
        out[f"{name}/y_mean"] = np.float64(model.y_mean)
        out[f"{name}/gamma_q"] = sd.build_guide(model).gamma_q
        print(f"{name}: fit on {N_TRAIN}, cycles {train_cycles.min()}.."
              f"{train_cycles.max()} ({time.time() - t:.0f} s)", flush=True)

        t = time.time()
        held = surrogate.sample_placements(g, nx, ny, N_HELD, seed=HELD_SEED,
                                           include_static=False)
        res = place.simulate_placements(g, nx, ny, list(held), cfg)
        assert all(r.done for r in res), name
        held_cycles = np.asarray([r.cycles for r in res], np.int64)
        pred = model.predict_batch(held)
        out[f"{name}/held/node_pe"] = held.astype(np.uint8)
        out[f"{name}/held/cycles"] = held_cycles
        out[f"{name}/held/pred"] = pred
        rho = surrogate.spearman(pred, held_cycles)
        keep = model.rank(held)[:8]
        print(f"{name}: held-out spearman {rho:.4f}, pruned best "
              f"{held_cycles[keep].min()} exhaustive {held_cycles.min()} "
              f"({time.time() - t:.0f} s)", flush=True)

        t = time.time()
        acfg = place.AnnealConfig(**kw)
        gcfg = dataclasses.replace(acfg,
                                   rounds=GUIDED_ROUNDS_SCALE * acfg.rounds)
        r = place.anneal_placement(g, nx, ny, gcfg, guide=model,
                                   guide_margin=GUIDED_MARGIN)
        out[f"{name}/guided/node_pe"] = r.node_pe.astype(np.uint8)
        out[f"{name}/guided/cost"] = np.int64(r.cost)
        out[f"{name}/guided/init_cost"] = np.int64(r.init_cost)
        out[f"{name}/guided/replica_costs"] = r.replica_costs
        out[f"{name}/guided/cost_evals"] = np.int64(r.cost_evals)
        out[f"{name}/guided/proposals"] = np.int64(r.proposals)
        print(f"{name}: guided cost {r.init_cost} -> {r.cost}, cost_evals "
              f"{r.cost_evals} of {r.proposals} ({time.time() - t:.0f} s)",
              flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
