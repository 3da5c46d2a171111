"""Self-generated training sets: sampled placements + their simulated cycles,
as in the reference package.

The surrogate learns from the simulator itself: sample a spread of candidate
placements (static heuristics, pure randoms, load-imbalanced randoms, and
perturbations of good layouts — the distribution a placement search actually
visits), simulate each once through the shape-unified path
(:func:`repro_torch.place.simulate_placements`), and fit the ridge model on
(features, cycles).

Sampling uses the counter-based Threefry stream of
:mod:`repro_torch.core.prng` (``fold_in`` per candidate, the reference's
``jax.random`` stream on the non-partitionable layout), so a fixed seed
yields the reference's placements bit for bit on every machine.
"""
from __future__ import annotations

import numpy as np

from ..core import prng
from ..core.graph import DataflowGraph
from ..core.partition import place_nodes

#: static heuristics mixed into every sample (searchers start near these).
_STATIC = ("round_robin", "blocked", "clustered", "bulk_clustered",
           "critical_chain")


def _randint(k, n: int, hi: int) -> np.ndarray:
    return prng.randint(k, (n,), 0, hi).numpy()


def sample_placements(g: DataflowGraph, nx: int, ny: int, n: int,
                      seed: int = 0, *,
                      include_static: bool = True) -> np.ndarray:
    """[n, N] int32 candidate placements spanning the search distribution.

    The first ``min(n, 5)`` rows are the static heuristics (skipped with
    ``include_static=False`` — held-out sets must not share rows with a
    training set that included them); the rest cycle deterministically
    through pure randoms, imbalanced randoms confined to a shrinking PE
    prefix (probing the pressure axis), and round-robin / clustered layouts
    with a growing fraction of nodes kicked to random PEs (probing the
    traffic axis near good layouts).
    """
    if n < 1:
        raise ValueError(f"need n >= 1 placements, got {n}")
    num_pes = nx * ny
    N = g.num_nodes
    key = prng.key(seed)
    out = []
    if include_static:
        for s in _STATIC[:min(n, len(_STATIC))]:
            out.append(place_nodes(g, num_pes, s))

    kinds = ("random", "imbalanced", "perturb_rr", "perturb_cl")
    i = 0
    while len(out) < n:
        k = prng.fold_in(key, i)
        kind = kinds[i % len(kinds)]
        if kind == "random":
            pe = _randint(k, N, num_pes)
        elif kind == "imbalanced":
            # Confine to a PE prefix of 1/2, 1/4, or 1/8 of the grid.
            frac = 2 ** (1 + (i // len(kinds)) % 3)
            hi = max(1, num_pes // frac)
            pe = _randint(k, N, hi)
        else:
            base = place_nodes(
                g, num_pes, "round_robin" if kind == "perturb_rr" else "clustered")
            # Kick 5% / 20% / 50% of nodes to uniform-random PEs.
            permille = (50, 200, 500)[(i // len(kinds)) % 3]
            k1, k2 = prng.split(k, 2)
            move = _randint(k1, N, 1000) < permille
            rand = _randint(k2, N, num_pes)
            pe = np.where(move, rand, np.asarray(base))
        out.append(np.asarray(pe, dtype=np.int32))
        i += 1
    return np.stack(out[:n]).astype(np.int32)


def make_training_set(g: DataflowGraph, nx: int, ny: int, *, cfg=None,
                      n: int = 64, seed: int = 0, mesh=None,
                      device=None) -> tuple[np.ndarray, np.ndarray]:
    """(placements [n, N] int32, cycles [n] int64): sample, then simulate on
    ``device`` (``None`` = the CUDA card).

    Every candidate must complete within ``cfg.max_cycles`` — a truncated run
    would poison the regression targets, so it raises instead.
    """
    from ..place.api import simulate_placements

    placements = sample_placements(g, nx, ny, n, seed=seed)
    results = simulate_placements(g, nx, ny, list(placements), cfg, mesh=mesh,
                                  device=device)
    undone = [i for i, r in enumerate(results) if not r.done]
    if undone:
        raise ValueError(
            f"{len(undone)} training placement(s) hit max_cycles "
            f"(first: {undone[0]}); raise cfg.max_cycles")
    cycles = np.asarray([r.cycles for r in results], dtype=np.int64)
    return placements, cycles
