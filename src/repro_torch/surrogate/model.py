"""Deterministic closed-form ridge regression from features to cycle counts,
as in the reference package.

The model is intentionally the simplest thing that ranks well: standardize
the integer feature matrix, center the targets, and solve the ridge normal
equations

    (Xs' Xs + ridge * n * I) beta = Xs' (y - mean(y))

once, in float64 (no iterative optimizer, no learning-rate knobs, no RNG).
For fixed inputs the coefficients are bit-reproducible run to run.

The means and scales are numpy's, as in the reference, so they are bit-equal
to its. The normal equations and their solve run in float64 on the host
(numpy's BLAS and LAPACK), never on the card: the system is 29 x 29, and
cuSOLVER's other summation order would give other last bits for no gain.
The reference's XLA solve and this one differ in the last bits of
``beta``, and the feature columns are nearly collinear, which magnifies
them (numpy's solve stays closer to the reference's than torch's CPU solve
on the BENCH surrogate rows). What the guided search reads is
``gamma_q = rint(beta / sigma * 2**16)`` (:mod:`.delta`), which such bits
move only where ``gamma * 2**16`` sits within that distance of a half
integer. The tests hold ``beta`` to the reference at rtol 1e-10 and
``gamma_q`` exactly.

Prediction cost is one [B, F] @ [F] matmul — pruning thousands of candidate
placements costs microseconds, against a full simulation each.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .features import FeatureExtractor


@dataclasses.dataclass(frozen=True)
class SurrogateModel:
    """Fitted ridge coefficients + the feature extractor they apply to."""

    extractor: FeatureExtractor
    mu: np.ndarray        # [F] float64 feature means (training set)
    sigma: np.ndarray     # [F] float64 feature scales (0 -> 1)
    beta: np.ndarray      # [F] float64 ridge coefficients
    y_mean: float         # training-target mean (intercept)
    ridge: float
    n_train: int

    def predict_batch(self, placements, device=None) -> np.ndarray:
        """[B] float64 predicted cycle counts of stacked [B, N] placements;
        the features are extracted on ``device`` (``None`` = the card)."""
        x = self.extractor.features_batch(placements, device=device)
        return self.y_mean + ((x - self.mu) / self.sigma) @ self.beta

    def predict(self, placement, device=None) -> float:
        return float(self.predict_batch(np.asarray(placement)[None],
                                        device=device)[0])

    def rank(self, placements, device=None) -> np.ndarray:
        """[B] candidate indices, best (fewest predicted cycles) first.

        Stable sort: prediction ties keep candidate order, so the ranking is
        as deterministic as the coefficients.
        """
        return np.argsort(self.predict_batch(placements, device=device),
                          kind="stable")


def fit_features(
    extractor: FeatureExtractor,
    features: np.ndarray,
    cycles: np.ndarray,
    *,
    ridge: float = 1e-3,
) -> SurrogateModel:
    """Closed-form ridge fit of ``features [n, F] -> cycles [n]``."""
    x = np.asarray(features, dtype=np.float64)
    y = np.asarray(cycles, dtype=np.float64)
    if x.ndim != 2 or y.shape != (x.shape[0],):
        raise ValueError(
            f"need features [n, F] and cycles [n]; got {x.shape} / {y.shape}")
    if x.shape[0] < 2:
        raise ValueError(f"need >= 2 training placements, got {x.shape[0]}")
    mu = x.mean(axis=0)
    sigma = x.std(axis=0)
    sigma = np.where(sigma == 0, 1.0, sigma)
    y_mean = float(y.mean())
    # float64 on the host, on purpose (see the module docstring)
    xs = (x - mu) / sigma
    yc = y - y_mean
    gram = xs.T @ xs + ridge * x.shape[0] * np.eye(x.shape[1])
    beta = np.linalg.solve(gram, xs.T @ yc)
    return SurrogateModel(
        extractor=extractor,
        mu=mu, sigma=sigma, beta=np.asarray(beta, dtype=np.float64),
        y_mean=y_mean, ridge=float(ridge), n_train=int(x.shape[0]),
    )


def spearman(a, b) -> float:
    """Spearman rank correlation with average-rank ties (pure numpy)."""

    def _ranks(v):
        v = np.asarray(v, dtype=np.float64)
        order = np.argsort(v, kind="stable")
        ranks = np.empty(len(v), dtype=np.float64)
        ranks[order] = np.arange(len(v), dtype=np.float64)
        # Average ranks across ties so equal values compare equal.
        uniq, inv, counts = np.unique(v, return_inverse=True,
                                      return_counts=True)
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, ranks)
        return sums[inv] / counts[inv]

    ra, rb = _ranks(a), _ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    return float((ra * rb).sum() / denom) if denom else 0.0
