"""The port's surrogate fit (``repro_torch.surrogate``, on the CPU) against
the reference's on the non-partitionable Threefry layout: sampled
placements bit for bit (static rows on and off, several seeds and sizes),
the fit's mu and sigma bit-equal, beta within a relative 1e-10 (the float64
solves differ in their last bits, ROADMAP fault 5) and gamma_q equal;
predictions, ``rank`` and ``spearman``; ``fit_from_sim`` end to end. The
BENCH surrogate rows' fits are held to ``tests/fixtures/surrogate_golden.npz``
from its placements and cycles (no simulation); those tests print how far
``gamma * 2**16`` sits from a rounding boundary of gamma_q.
"""
from pathlib import Path

import numpy as np
import pytest

from _torch_ref import run_reference

from repro_torch import surrogate
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.surrogate import delta as sd

GOLDEN = Path(__file__).parent / "fixtures" / "surrogate_golden.npz"
#: The reference surrogate tests' graph and grid.
G_ARGS, NX, NY = (2, 6, 4, 5), 4, 4
CFG = dict(max_cycles=200_000)
N_TRAIN = 12
#: sample_placements cases: (n, seed, include_static).
SAMPLES = [(12, 0, True), (12, 1, True), (9, 101, False), (3, 4, True)]
BENCH = {"n3689": ((2, 8, 6), (8, 8)), "n10308": ((4, 8, 8), (16, 16))}
#: beta's relative tolerance against the reference's (see the docstring).
BETA_RTOL = 1e-10


def _graph():
    return wl.arrow_lu_graph(*G_ARGS[:3], seed=G_ARGS[3])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    from repro import surrogate
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.surrogate import delta as sd

    g = wl.arrow_lu_graph(*{G_ARGS[:3]!r}, seed={G_ARGS[3]})
    for k, (n, seed, static) in enumerate({SAMPLES!r}):
        res[f"sample/{{k}}"] = surrogate.sample_placements(
            g, {NX}, {NY}, n, seed=seed, include_static=static)
    m, p, c = surrogate.fit_from_sim(g, {NX}, {NY},
                                     cfg=OverlayConfig(**{CFG!r}),
                                     n_train={N_TRAIN}, seed=0)
    res["train/node_pe"], res["train/cycles"] = p, c
    for k in ("mu", "sigma", "beta"):
        res["fit/" + k] = getattr(m, k)
    res["fit/y_mean"] = np.float64(m.y_mean)
    res["fit/gamma_q"] = sd.build_guide(m).gamma_q
    held = surrogate.sample_placements(g, {NX}, {NY}, 10, seed=3,
                                       include_static=False)
    res["held"] = held
    res["pred"] = m.predict_batch(held)
    res["rank"] = m.rank(held)
    res["spearman"] = np.float64(surrogate.spearman(res["pred"],
                                                    np.arange(10)[::-1]))
    """
    return run_reference(tmp_path_factory, "surrogate_model", body,
                         legacy_prng=True)


@pytest.fixture(scope="module")
def port_fit():
    """The port's fit_from_sim on the CPU, end to end."""
    return surrogate.fit_from_sim(_graph(), NX, NY,
                                  cfg=OverlayConfig(**CFG), n_train=N_TRAIN,
                                  seed=0, device="cpu")


def _gamma_margin(model) -> float:
    gam = model.beta / model.sigma * sd.GUIDE_SCALE
    return float(np.min(np.abs(gam - np.floor(gam) - 0.5)))


@pytest.mark.parametrize("k", range(len(SAMPLES)))
def test_sample_placements_equal_reference(reference, k):
    n, seed, static = SAMPLES[k]
    got = surrogate.sample_placements(_graph(), NX, NY, n, seed=seed,
                                      include_static=static)
    assert got.dtype == np.int32 and got.shape == reference[f"sample/{k}"].shape
    np.testing.assert_array_equal(got, reference[f"sample/{k}"])


def test_sample_placements_errors():
    with pytest.raises(ValueError, match="n >= 1"):
        surrogate.sample_placements(_graph(), NX, NY, 0)


def test_fit_equals_reference(reference):
    m = surrogate.fit(_graph(), NX, NY, reference["train/node_pe"],
                      reference["train/cycles"], device="cpu")
    np.testing.assert_array_equal(m.mu, reference["fit/mu"])
    np.testing.assert_array_equal(m.sigma, reference["fit/sigma"])
    assert m.y_mean == float(reference["fit/y_mean"])
    np.testing.assert_allclose(m.beta, reference["fit/beta"], rtol=BETA_RTOL,
                               atol=0)
    np.testing.assert_array_equal(sd.build_guide(m).gamma_q,
                                  reference["fit/gamma_q"])
    print(f"gamma * 2^16 is {_gamma_margin(m):.6f} from a rounding boundary")


def test_predict_rank_spearman_equal_reference(reference):
    m = surrogate.fit(_graph(), NX, NY, reference["train/node_pe"],
                      reference["train/cycles"], device="cpu")
    held = reference["held"]
    # predictions share beta's last-bit difference: 1e-9 relative
    np.testing.assert_allclose(m.predict_batch(held, device="cpu"),
                               reference["pred"], rtol=1e-9, atol=0)
    np.testing.assert_array_equal(surrogate.rank(m, held, device="cpu"),
                                  reference["rank"])
    assert surrogate.spearman(reference["pred"], np.arange(10)[::-1]) == \
        float(reference["spearman"])
    assert m.predict(held[0], device="cpu") == pytest.approx(
        float(reference["pred"][0]), rel=1e-9)


def test_spearman_helper():
    assert surrogate.spearman([1, 2, 3], [10, 20, 30]) == 1.0
    assert surrogate.spearman([1, 2, 3], [30, 20, 10]) == -1.0
    assert abs(surrogate.spearman([1, 1, 2], [1, 1, 2]) - 1.0) < 1e-12
    assert surrogate.spearman([1, 1, 1], [1, 2, 3]) == 0.0


def test_fit_from_sim_end_to_end(reference, port_fit):
    m, placements, cycles = port_fit
    np.testing.assert_array_equal(placements, reference["train/node_pe"])
    np.testing.assert_array_equal(cycles, reference["train/cycles"])
    np.testing.assert_array_equal(m.mu, reference["fit/mu"])
    np.testing.assert_array_equal(m.sigma, reference["fit/sigma"])
    np.testing.assert_allclose(m.beta, reference["fit/beta"], rtol=BETA_RTOL,
                               atol=0)
    np.testing.assert_array_equal(sd.build_guide(m).gamma_q,
                                  reference["fit/gamma_q"])
    assert m.n_train == N_TRAIN and m.ridge == 1e-3
    refit = surrogate.fit(_graph(), NX, NY, placements, cycles, device="cpu")
    np.testing.assert_array_equal(refit.beta, m.beta)


def test_fit_errors():
    ex = surrogate.build_features(_graph(), NX, NY)
    with pytest.raises(ValueError, match="need features"):
        surrogate.fit_features(ex, np.zeros((3, 29)), np.zeros(2))
    with pytest.raises(ValueError, match=">= 2 training"):
        surrogate.fit_features(ex, np.zeros((1, 29)), np.zeros(1))


@pytest.mark.parametrize("row", list(BENCH))
def test_bench_fit_equals_fixture(row):
    """The BENCH rows' fits from the fixture's placements and cycles: mu
    and sigma bit-equal, beta within BETA_RTOL, gamma_q equal; prints the
    gamma_q rounding margin."""
    args, grid = BENCH[row]
    g = wl.arrow_lu_graph(*args, seed=3)
    with np.load(GOLDEN) as z:
        want = {k: z[f"{row}/{k}"] for k in (
            "train/node_pe", "train/cycles", "mu", "sigma", "beta",
            "gamma_q", "y_mean")}
    m = surrogate.fit(g, *grid, want["train/node_pe"].astype(np.int32),
                      want["train/cycles"], device="cpu")
    np.testing.assert_array_equal(m.mu, want["mu"])
    np.testing.assert_array_equal(m.sigma, want["sigma"])
    assert m.y_mean == float(want["y_mean"])
    np.testing.assert_allclose(m.beta, want["beta"], rtol=BETA_RTOL, atol=0)
    np.testing.assert_array_equal(sd.build_guide(m).gamma_q, want["gamma_q"])
    rel = np.max(np.abs(m.beta - want["beta"]) / np.abs(want["beta"]))
    print(f"{row}: beta max relative error {rel:.3e}; gamma * 2^16 is "
          f"{_gamma_margin(m):.6f} from a rounding boundary")
