"""Surrogate smoke: ``python -m repro_torch.surrogate [--smoke] [--device cpu]``.

Runs the whole subsystem end to end on a small Fig. 1-family workload
(``arrow_lu_graph(2, 8, 6, seed=3)``, 3,689 nodes, 8x8) and asserts the
reference smoke's contracts:

  * fixed-key fit -> bit-identical coefficients across two fits;
  * in-sample rank quality: Spearman >= 0.8 between predictions and
    simulated cycles on the training set;
  * pruning: ``evaluate_placements(prune="surrogate", keep_top=k)`` returns
    exactly k simulated candidates, and the best of them is within 10% of
    the exhaustive best;
  * multilevel placement: identity-coarsened anneal reproduces the plain
    annealer bit-exactly, and a coarse-annealed placement beats round-robin
    on simulated cycles;
  * guided annealing: the incremental delta features match a batch
    recompute bit-exactly, the open-gate (margin = inf) guided search
    reproduces the unguided annealer bit for bit, and a margin-0 gate
    filters proposals (cost_evals < proposals) deterministically.

Runs on the CUDA card (the anneal kernel and its ``GUIDED`` instantiation,
the megakernel engine) unless ``--device cpu`` is given (without a card and
without ``--device cpu`` it raises). Prints one line of results; exits
non-zero on any violation.
"""
from __future__ import annotations

import argparse
import sys


def smoke(device=None) -> str:
    import numpy as np

    from repro_torch import place, surrogate
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.surrogate import delta as sd

    g = wl.arrow_lu_graph(2, 8, 6, seed=3)
    nx = ny = 8
    cfg = OverlayConfig(max_cycles=200_000, engine="megakernel")

    # 1. Determinism: same key, same data -> bit-identical coefficients.
    m1, placements, cycles = surrogate.fit_from_sim(
        g, nx, ny, cfg=cfg, n_train=24, seed=0, device=device)
    m2 = surrogate.fit(g, nx, ny, placements, cycles, device=device)
    np.testing.assert_array_equal(m1.beta, m2.beta)
    np.testing.assert_array_equal(m1.mu, m2.mu)

    # 2. In-sample rank quality.
    rho = surrogate.spearman(m1.predict_batch(placements, device=device),
                             cycles)
    assert rho >= 0.8, f"in-sample spearman {rho:.3f} < 0.8"

    # 3. Pruned evaluation: k simulated candidates, near-exhaustive best.
    cands = surrogate.sample_placements(g, nx, ny, 16, seed=7)
    names = {f"cand{i}": p for i, p in enumerate(cands)}
    full = place.evaluate_placements(g, nx, ny, names, cfgs=cfg,
                                     device=device)
    pruned = place.evaluate_placements(
        g, nx, ny, names, cfgs=cfg, prune="surrogate", keep_top=4,
        surrogate=m1, device=device)
    assert len(pruned) == 4 and set(pruned) <= set(full)
    best_full = min(r.cycles for r in full.values())
    best_pruned = min(r.cycles for r in pruned.values())
    assert best_pruned <= 1.10 * best_full, (best_pruned, best_full)

    # 4. Multilevel: identity clusters == plain annealer, bit-exactly;
    #    coarse-annealed beats round-robin on simulated cycles.
    acfg = place.AnnealConfig(replicas=6, rounds=12, steps=256, seed=0)
    plain = place.anneal_placement(g, nx, ny, acfg, device=device)
    ident = place.multilevel_anneal(
        g, nx, ny, acfg, clusters=np.arange(g.num_nodes), refine=None,
        device=device)
    np.testing.assert_array_equal(ident.node_pe, plain.node_pe)
    ml = place.multilevel_anneal(
        g, nx, ny, place.AnnealConfig(replicas=8, rounds=16, steps=384, seed=0),
        ratio=8,
        refine=place.AnnealConfig(replicas=6, rounds=12, steps=512, seed=0),
        device=device)
    res = place.evaluate_placements(g, nx, ny, {
        "round_robin": "round_robin", "multilevel": ml.node_pe}, cfgs=cfg,
        device=device)
    rr, mlr = res["round_robin"], res["multilevel"]
    assert rr.done and mlr.done
    assert mlr.cycles < rr.cycles, (mlr.cycles, rr.cycles)

    # 5. Guided annealing: delta features == batch recompute bit-exactly
    #    after a random move sequence; open gate == unguided bit-exactly;
    #    a margin-0 gate actually filters, deterministically.
    import torch

    from repro_torch.api import resolve_device

    dev = resolve_device(device)
    guide = sd.build_guide(m1)
    ga = sd.to_device(sd.guide_arrays(guide), dev)
    rng = np.random.default_rng(11)
    pe = rng.integers(0, nx * ny, size=g.num_nodes).astype(np.int32)
    st = sd.state_init(ga, torch.from_numpy(pe).to(dev), nx=nx, ny=ny)
    for _ in range(64):
        i = int(rng.integers(0, g.num_nodes))
        q = int(rng.integers(0, nx * ny))
        st, _ = sd.apply_move(ga, st, torch.from_numpy(pe).to(dev), i, q,
                              nx=nx, ny=ny)
        pe[i] = q
    np.testing.assert_array_equal(
        st.feats.cpu().numpy(),
        m1.extractor.features_batch(pe, device=device)[0].astype(np.int64))
    open_gate = place.anneal_placement(g, nx, ny, acfg, guide=m1,
                                       guide_margin=float("inf"),
                                       device=device)
    np.testing.assert_array_equal(open_gate.node_pe, plain.node_pe)
    assert open_gate.cost_evals == open_gate.proposals
    g1 = place.anneal_placement(g, nx, ny, acfg, guide=m1, guide_margin=0.0,
                                device=device)
    g2 = place.anneal_placement(g, nx, ny, acfg, guide=m1, guide_margin=0.0,
                                device=device)
    np.testing.assert_array_equal(g1.node_pe, g2.node_pe)
    assert 0 < g1.cost_evals < g1.proposals
    assert g1.cost <= g1.init_cost

    return (f"surrogate smoke OK: spearman={rho:.3f}, "
            f"pruned best {best_pruned} vs exhaustive {best_full} "
            f"({len(pruned)}/{len(full)} sims), "
            f"multilevel {mlr.cycles} < round_robin {rr.cycles} cycles "
            f"({ml.num_clusters} clusters for {g.num_nodes} nodes), "
            f"guided gate pass-rate {g1.eval_ratio:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.surrogate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the surrogate smoke (the default and only mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print(smoke(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
