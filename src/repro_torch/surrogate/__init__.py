"""repro_torch.surrogate — batched cycle-count prediction for placement
search, as in the reference package.

``repro_torch.place`` scores every candidate placement by full cycle-accurate
simulation. This package is the cheap bridge from a placement to its cycles:

  * :mod:`.features` — integer features of a ``(DataflowGraph, placement,
    grid)`` triple: hop-weighted traffic, slot pressure, inject/eject port
    contention, torus ring loads, and a criticality-depth histogram of
    per-wavefront load imbalance; batched int64 tensor ops on a device;
  * :mod:`.model`    — deterministic closed-form ridge regression (float64 on
    the host, no RNG);
  * :mod:`.data`     — self-generated training sets: counter-based-key
    placement sampling (:mod:`repro_torch.core.prng`) + simulation;
  * :mod:`.delta`    — the O(degree) incremental features and the quantized
    guide of the surrogate-guided anneal.

Top-level API:

  * :func:`fit` — features + closed-form ridge over (placements, cycles);
  * :func:`fit_from_sim` — sample, simulate, fit, in one call;
  * :func:`predict_batch` / :func:`rank` — score / order a stacked candidate
    batch with a fitted model.

Features and simulations run on ``device`` (``None`` = the CUDA card; pass
``"cpu"`` to run on the CPU). ``repro_torch.place.evaluate_placements(...,
prune="surrogate", keep_top=k)`` uses :meth:`SurrogateModel.rank` to simulate
only the k best-predicted candidates. ``python -m repro_torch.surrogate``
runs the smoke.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import DataflowGraph
from .data import make_training_set, sample_placements  # noqa: F401
from .delta import (  # noqa: F401
    GUIDE_SCALE,
    Guide,
    build_guide,
)
from .features import (  # noqa: F401
    DEPTH_BUCKETS,
    FeatureExtractor,
    build_features,
    coarsen_extractor,
    features_from_tables,
)
from .model import (  # noqa: F401
    SurrogateModel,
    fit_features,
    spearman,
)


def fit(g: DataflowGraph, nx: int, ny: int, placements, cycles, *,
        metric: str = "height", crit_scale: int = 3,
        ridge: float = 1e-3, device=None) -> SurrogateModel:
    """Fit a cycle-count surrogate on simulated ``(placements, cycles)``.

    ``placements`` is a stacked ``[n, N]`` int array (or a list of ``[N]``
    vectors); ``cycles`` the matching simulated cycle counts. The features
    are extracted on ``device``.
    """
    extractor = build_features(g, nx, ny, metric=metric,
                               crit_scale=crit_scale)
    x = extractor.features_batch(
        np.stack([np.asarray(p) for p in placements]), device=device)
    return fit_features(extractor, x, cycles, ridge=ridge)


def fit_from_sim(g: DataflowGraph, nx: int, ny: int, *, cfg=None,
                 n_train: int = 48, seed: int = 0, mesh=None,
                 metric: str = "height", crit_scale: int = 3,
                 ridge: float = 1e-3, device=None):
    """Sample ``n_train`` placements, simulate them on ``device``, fit.

    Returns ``(model, placements, cycles)`` so callers can account for the
    simulations spent on training.
    """
    placements, cycles = make_training_set(
        g, nx, ny, cfg=cfg, n=n_train, seed=seed, mesh=mesh, device=device)
    model = fit(g, nx, ny, placements, cycles, metric=metric,
                crit_scale=crit_scale, ridge=ridge, device=device)
    return model, placements, cycles


def predict_batch(model: SurrogateModel, placements,
                  device=None) -> np.ndarray:
    """[B] float64 predicted cycle counts (module-level convenience)."""
    return model.predict_batch(placements, device=device)


def rank(model: SurrogateModel, placements, device=None) -> np.ndarray:
    """[B] candidate indices, best predicted first (module-level
    convenience)."""
    return model.rank(placements, device=device)
