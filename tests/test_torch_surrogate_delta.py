"""The port's incremental surrogate features (``repro_torch.surrogate.delta``,
on the CPU) against the reference's ``repro.surrogate.delta``: the guide's
tables (fine and coarsened), the O(E) start state, and a sequence of
single-item moves whose features and quantized scores (``dscore``) must
equal the reference's step by step and a fresh batch recompute; slopes large
enough to make ``dscore`` wrap, which must wrap as the reference's int64
does; batched leading axes; ``quantize_margin``.
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_reference

from repro_torch import place, surrogate
from repro_torch.core import workloads as wl
from repro_torch.surrogate import delta as sd

G_ARGS, NX, NY = (2, 6, 4, 3), 4, 5          # non-square: catches x/y swaps
MOVES = 40
#: slopes: "small" ones of a fitted model's size, "huge" ones whose products
#: overflow int64 (dscore wraps).
SLOPES = {"small": (7, 1 << 20), "huge": (8, 1 << 62)}
ARRAYS = ("src", "dst", "w_edge", "c_unit", "e_unit", "w_node", "n_unit",
          "w_bucket", "nbr", "out_inc", "w_inc", "c_inc", "u_inc", "gamma_q")
STATE = ("t_w", "t_u", "t_c", "loads", "counts", "inject", "eject", "ring_x",
         "ring_y", "lvl", "feats")


def _graph():
    return wl.arrow_lu_graph(*G_ARGS[:3], seed=G_ARGS[3])


def _gamma(kind):
    seed, top = SLOPES[kind]
    return np.random.default_rng(seed).integers(-top, top, 29).astype(np.int64)


def _moves():
    """(start placement, [(item, PE)] moves) from a numpy seed."""
    g = _graph()
    rng = np.random.default_rng(7)
    pe = rng.integers(0, NX * NY, size=g.num_nodes).astype(np.int32)
    moves = [(int(rng.integers(0, g.num_nodes)), int(rng.integers(0, NX * NY)))
             for _ in range(MOVES)]
    return pe, moves


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pe, moves = _moves()
    clusters = place.cluster_nodes(_graph(), 8)
    body = f"""
    from jax.experimental import enable_x64
    from repro import surrogate
    from repro.core import workloads as wl
    from repro.surrogate import delta as sd

    g = wl.arrow_lu_graph(*{G_ARGS[:3]!r}, seed={G_ARGS[3]})
    ex = surrogate.build_features(g, {NX}, {NY})
    for kind, gamma in {{k: np.array(v, np.int64) for k, v in {
        {k: _gamma(k).tolist() for k in SLOPES}!r}.items()}}.items():
        ga = sd.guide_arrays(sd.Guide(extractor=ex, gamma_q=gamma))
        for name in {ARRAYS!r}:
            res[f"{{kind}}/arrays/{{name}}"] = np.asarray(getattr(ga, name))
        pe = np.array({pe.tolist()!r}, np.int32)
        with enable_x64():
            st = sd.state_init(ga, pe, nx={NX}, ny={NY})
            for name in {STATE!r}:
                res[f"{{kind}}/init/{{name}}"] = np.asarray(getattr(st, name))
            scores, feats = [], []
            for i, q in {moves!r}:
                st, ds = sd.apply_move(ga, st, pe, i, np.int32(q),
                                       nx={NX}, ny={NY})
                pe = pe.copy()
                pe[i] = q
                scores.append(int(ds))
                feats.append(np.asarray(st.feats))
            for name in {STATE!r}:
                res[f"{{kind}}/end/{{name}}"] = np.asarray(getattr(st, name))
        res[f"{{kind}}/dscore"] = np.array(scores, np.int64)
        res[f"{{kind}}/feats"] = np.stack(feats)
    cga = sd.guide_arrays(sd.Guide(extractor=ex, gamma_q=np.arange(29)).coarsen(
        np.array({clusters.tolist()!r})))
    for name in {ARRAYS!r}:
        res[f"coarse/{{name}}"] = np.asarray(getattr(cga, name))
    """
    return run_reference(tmp_path_factory, "surrogate_delta", body)


def _guide(kind):
    return sd.Guide(extractor=surrogate.build_features(_graph(), NX, NY),
                    gamma_q=_gamma(kind))


@pytest.mark.parametrize("kind", list(SLOPES))
def test_guide_arrays_equal_reference(reference, kind):
    ga = sd.guide_arrays(_guide(kind))
    for name in ARRAYS:
        want = reference[f"{kind}/arrays/{name}"]
        got = np.asarray(getattr(ga, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_coarse_guide_arrays_equal_reference(reference):
    clusters = place.cluster_nodes(_graph(), 8)
    guide = sd.Guide(extractor=surrogate.build_features(_graph(), NX, NY),
                     gamma_q=np.arange(29))
    cga = sd.guide_arrays(guide.coarsen(clusters))
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(cga, name)),
                                      reference[f"coarse/{name}"],
                                      err_msg=name)


@pytest.mark.parametrize("kind", list(SLOPES))
def test_state_init_equals_reference_and_recompute(reference, kind):
    pe, _ = _moves()
    ga = sd.to_device(sd.guide_arrays(_guide(kind)), "cpu")
    st = sd.state_init(ga, torch.from_numpy(pe), nx=NX, ny=NY)
    for name in STATE:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      reference[f"{kind}/init/{name}"],
                                      err_msg=name)
    ex = surrogate.build_features(_graph(), NX, NY)
    np.testing.assert_array_equal(
        st.feats.numpy(), ex.features_batch(pe, device="cpu")[0].astype(
            np.int64))


@pytest.mark.parametrize("kind", list(SLOPES))
def test_apply_move_equals_reference_and_recompute(reference, kind):
    """Every move's features and dscore equal the reference's; the carried
    features equal a fresh batch recompute, and dscore equals
    gamma_q @ (f_new - f_old) in wrapping int64."""
    pe, moves = _moves()
    guide = _guide(kind)
    ga = sd.to_device(sd.guide_arrays(guide), "cpu")
    ex = guide.extractor
    st = sd.state_init(ga, torch.from_numpy(pe), nx=NX, ny=NY)
    wrapped = 0
    for k, (i, q) in enumerate(moves):
        old = st.feats.numpy().copy()
        st, ds = sd.apply_move(ga, st, torch.from_numpy(pe), i, q,
                               nx=NX, ny=NY)
        pe = pe.copy()
        pe[i] = q
        assert int(ds) == int(reference[f"{kind}/dscore"][k]), k
        np.testing.assert_array_equal(st.feats.numpy(),
                                      reference[f"{kind}/feats"][k])
        with np.errstate(over="ignore"):
            assert int(ds) == int(np.sum(guide.gamma_q * (st.feats.numpy()
                                                          - old)))
        exact = sum(int(gq) * (int(a) - int(b)) for gq, a, b in
                    zip(guide.gamma_q, st.feats.numpy(), old))
        wrapped += exact != int(ds)
        if k % 10 == 9:
            np.testing.assert_array_equal(
                st.feats.numpy(),
                ex.features_batch(pe, device="cpu")[0].astype(np.int64))
    for name in STATE:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      reference[f"{kind}/end/{name}"],
                                      err_msg=name)
    # the huge slopes overflow int64, and the scores wrapped as the
    # reference's did; the small ones never do
    assert (wrapped > 0) == (kind == "huge")


def test_apply_move_batched_equals_single():
    """Leading axes: a [3, 2] batch of placements and moves gives each
    element's single-placement state and score."""
    g = _graph()
    ga = sd.to_device(sd.guide_arrays(_guide("small")), "cpu")
    rng = np.random.default_rng(3)
    pe = torch.from_numpy(rng.integers(0, NX * NY, (3, 2, g.num_nodes)))
    i = torch.from_numpy(rng.integers(0, g.num_nodes, (3, 2)))
    q = torch.from_numpy(rng.integers(0, NX * NY, (3, 2)))
    st = sd.state_init(ga, pe, nx=NX, ny=NY)
    new, ds = sd.apply_move(ga, st, pe, i, q, nx=NX, ny=NY)
    for a in range(3):
        for b in range(2):
            one = sd.state_init(ga, pe[a, b], nx=NX, ny=NY)
            one_new, one_ds = sd.apply_move(ga, one, pe[a, b], i[a, b],
                                            q[a, b], nx=NX, ny=NY)
            assert int(ds[a, b]) == int(one_ds)
            for x, y in zip(new, one_new):
                assert torch.equal(x[a, b], y)


def test_quantize_margin():
    assert sd.quantize_margin(0.0) == 0
    assert sd.quantize_margin(1.0) == sd.GUIDE_SCALE
    assert sd.quantize_margin(-2.5) == -(5 * sd.GUIDE_SCALE) // 2
    assert sd.quantize_margin(float("inf")) == np.iinfo(np.int64).max
    assert sd.quantize_margin(float("-inf")) == np.iinfo(np.int64).min


def test_build_guide_quantizes_slopes():
    ex = surrogate.build_features(_graph(), NX, NY)
    beta = np.linspace(-3.0, 2.0, 29)
    sigma = np.linspace(0.5, 40.0, 29)
    model = surrogate.SurrogateModel(extractor=ex, mu=np.zeros(29),
                                     sigma=sigma, beta=beta, y_mean=0.0,
                                     ridge=1e-3, n_train=2)
    guide = sd.build_guide(model)
    np.testing.assert_array_equal(
        guide.gamma_q, np.rint(beta / sigma * sd.GUIDE_SCALE).astype(np.int64))
    clusters = place.cluster_nodes(_graph(), 8)
    np.testing.assert_array_equal(guide.coarsen(clusters).gamma_q,
                                  guide.gamma_q)
