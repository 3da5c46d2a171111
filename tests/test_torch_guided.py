"""The port's surrogate-guided search (``repro_torch.place.anneal``'s
``anneal_guided_plain`` on the CPU, through ``anneal_placement(guide=)``)
against the reference's ``_anneal_guided_jit`` on the non-partitionable
Threefry layout, bit for bit at the reference tests' size
(``arrow_lu_graph(2, 6, 4)`` on the non-square 4x5, ``AnnealConfig(6, 8,
128)``, a surrogate fitted on 12 simulated placements): best placements,
costs, init costs, per-replica costs and cost evaluations at margins 0 and
inf and guide_every 1 and 3; the open gate equal to the unguided search;
multilevel guided (coarse guide on the quotient graph, fine guide in the
refinement); ``resolve`` of a guided spec with and without ``guide_model``;
``evaluate_placements(prune="surrogate")`` with a given and an on-the-spot
model; the guide's checks.
"""
import dataclasses

import numpy as np
import pytest

from _torch_ref import run_reference

from repro_torch import place, surrogate
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig

G_ARGS, NX, NY = (2, 6, 4, 3), 4, 5
ACFG = dict(replicas=6, rounds=8, steps=128, seed=0)
#: (guide_margin, guide_every) of the parity cases.
CASES = [(0.0, 1), (0.0, 3), (float("inf"), 1), (float("inf"), 3)]
#: the smaller budgets of the multilevel and resolve cases.
ML_ACFG = dict(replicas=6, rounds=4, steps=64, seed=1)
SPEC_ACFG = dict(replicas=4, rounds=2, steps=64, seed=0)
CFG = dict(max_cycles=200_000)
N_TRAIN, SPEC_TRAIN, PRUNE_TRAIN = 12, 8, 8


def _graph():
    return wl.arrow_lu_graph(*G_ARGS[:3], seed=G_ARGS[3])


def _spec():
    return place.PlacementSpec(
        strategy="anneal", guide="surrogate",
        anneal=place.AnnealConfig(**SPEC_ACFG), guide_margin=0.0,
        guide_train=SPEC_TRAIN, seed=2)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    from repro import place, surrogate
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig

    inf = float("inf")

    def result(key, r):
        for f in ("node_pe", "replica_costs"):
            res[f"{{key}}/{{f}}"] = np.asarray(getattr(r, f))
        for f in ("cost", "init_cost", "cost_evals", "proposals"):
            if hasattr(r, f):
                res[f"{{key}}/{{f}}"] = np.int64(getattr(r, f))

    g = wl.arrow_lu_graph(*{G_ARGS[:3]!r}, seed={G_ARGS[3]})
    cfg = OverlayConfig(**{CFG!r})
    m, p, c = surrogate.fit_from_sim(g, {NX}, {NY}, cfg=cfg,
                                     n_train={N_TRAIN}, seed=0)
    res["train/node_pe"], res["train/cycles"] = p, c
    acfg = place.AnnealConfig(**{ACFG!r})
    result("plain", place.anneal_placement(g, {NX}, {NY}, acfg))
    for k, (margin, every) in enumerate({CASES!r}):
        result(f"case{{k}}", place.anneal_placement(
            g, {NX}, {NY}, acfg, guide=m, guide_margin=margin,
            guide_every=every))
    ml = place.multilevel_anneal(g, {NX}, {NY},
                                 place.AnnealConfig(**{ML_ACFG!r}), ratio=8,
                                 guide=m, guide_margin=0.0, guide_every=2)
    res["ml/node_pe"] = ml.node_pe
    res["ml/projected_cost"] = np.int64(ml.projected_cost)
    result("ml/coarse", ml.coarse)
    result("ml/refined", ml.refined)
    spec = place.PlacementSpec(
        strategy="anneal", guide="surrogate",
        anneal=place.AnnealConfig(**{SPEC_ACFG!r}), guide_margin=0.0,
        guide_train={SPEC_TRAIN}, seed=2)
    res["resolve/prefit"] = place.resolve(g, {NX}, {NY}, spec, guide_model=m)
    res["resolve/auto"] = place.resolve(g, {NX}, {NY}, spec)
    cands = surrogate.sample_placements(g, {NX}, {NY}, 10, seed=3)
    names = {{f"c{{i}}": q for i, q in enumerate(cands)}}
    pruned = place.evaluate_placements(g, {NX}, {NY}, names, cfgs=cfg,
                                       prune="surrogate", keep_top=3,
                                       surrogate=m)
    res["prune/names"] = np.array([int(k[1:]) for k in pruned])
    res["prune/cycles"] = np.array([r.cycles for r in pruned.values()])
    auto = place.evaluate_placements(g, {NX}, {NY}, names, cfgs=cfg,
                                     prune="surrogate", keep_top=2,
                                     surrogate_train={PRUNE_TRAIN})
    res["prune_auto/names"] = np.array([int(k[1:]) for k in auto])
    res["prune_auto/cycles"] = np.array([r.cycles for r in auto.values()])
    """
    return run_reference(tmp_path_factory, "guided", body, legacy_prng=True)


@pytest.fixture(scope="module")
def model(reference):
    """The port's fit of the reference's training set (equal gamma_q:
    ``tests/test_torch_surrogate_model.py``)."""
    return surrogate.fit(_graph(), NX, NY, reference["train/node_pe"],
                         reference["train/cycles"], device="cpu")


def _assert_equal(r, reference, key):
    np.testing.assert_array_equal(r.node_pe, reference[f"{key}/node_pe"])
    np.testing.assert_array_equal(r.replica_costs,
                                  reference[f"{key}/replica_costs"])
    for f in ("cost", "init_cost", "cost_evals", "proposals"):
        if f"{key}/{f}" in reference:
            assert getattr(r, f) == int(reference[f"{key}/{f}"]), f


@pytest.mark.parametrize("k", range(len(CASES)))
def test_guided_equals_reference(reference, model, k):
    margin, every = CASES[k]
    r = place.anneal_placement(_graph(), NX, NY, place.AnnealConfig(**ACFG),
                               guide=model, guide_margin=margin,
                               guide_every=every, device="cpu")
    assert isinstance(r, place.GuidedPlacementResult)
    _assert_equal(r, reference, f"case{k}")
    assert r.proposals == ACFG["replicas"] * ACFG["rounds"] * ACFG["steps"]
    assert r.eval_ratio == r.cost_evals / r.proposals
    if margin == float("inf"):
        # the open gate is the unguided search, and every proposal counts
        _assert_equal(r, reference, "plain")
        assert r.cost_evals == r.proposals
    else:
        assert 0 < r.cost_evals < r.proposals
        assert r.cost <= r.init_cost


def test_open_gate_equals_unguided_on_the_port(model):
    acfg = place.AnnealConfig(replicas=3, rounds=2, steps=32, seed=4,
                              t_max=300.0)
    plain = place.anneal_placement(_graph(), NX, NY, acfg, device="cpu")
    guided = place.anneal_placement(_graph(), NX, NY, acfg, guide=model,
                                    guide_margin=float("inf"), guide_every=2,
                                    device="cpu")
    np.testing.assert_array_equal(plain.node_pe, guided.node_pe)
    np.testing.assert_array_equal(plain.replica_costs, guided.replica_costs)
    assert (plain.cost, plain.init_cost) == (guided.cost, guided.init_cost)
    assert guided.cost_evals == guided.proposals


def test_multilevel_guided_equals_reference(reference, model):
    ml = place.multilevel_anneal(_graph(), NX, NY,
                                 place.AnnealConfig(**ML_ACFG), ratio=8,
                                 guide=model, guide_margin=0.0, guide_every=2,
                                 device="cpu")
    np.testing.assert_array_equal(ml.node_pe, reference["ml/node_pe"])
    assert ml.projected_cost == int(reference["ml/projected_cost"])
    assert isinstance(ml.coarse, place.GuidedPlacementResult)
    assert isinstance(ml.refined, place.GuidedPlacementResult)
    _assert_equal(ml.coarse, reference, "ml/coarse")
    _assert_equal(ml.refined, reference, "ml/refined")


def test_resolve_guided_spec(reference, model):
    spec = _spec()
    via_prefit = place.resolve(_graph(), NX, NY, spec, guide_model=model,
                               device="cpu")
    np.testing.assert_array_equal(via_prefit, reference["resolve/prefit"])
    direct = place.anneal_placement(
        _graph(), NX, NY, spec.anneal_config, guide=model, guide_margin=0.0,
        device="cpu")
    np.testing.assert_array_equal(via_prefit, direct.node_pe)
    # no model: one is fitted on the spot from spec.guide_train simulations
    auto = place.resolve(_graph(), NX, NY, spec, device="cpu")
    np.testing.assert_array_equal(auto, reference["resolve/auto"])


def test_guided_spec_in_overlay_config():
    spec = _spec()
    cfg = OverlayConfig(placement=spec)
    assert cfg.placement == spec and hash(cfg) == hash(OverlayConfig(
        placement=_spec()))
    ml = place.PlacementSpec(strategy="multilevel", guide="surrogate")
    assert OverlayConfig(placement=ml).placement.guide == "surrogate"
    with pytest.raises(ValueError, match="search strategy"):
        place.PlacementSpec(strategy="random", guide="surrogate")
    with pytest.raises(ValueError, match="guide"):
        place.PlacementSpec(strategy="anneal", guide="bogus")


def test_evaluate_placements_prune(reference, model):
    g = _graph()
    cands = surrogate.sample_placements(g, NX, NY, 10, seed=3)
    names = {f"c{i}": q for i, q in enumerate(cands)}
    cfg = OverlayConfig(**CFG)
    pruned = place.evaluate_placements(g, NX, NY, names, cfgs=cfg,
                                       prune="surrogate", keep_top=3,
                                       surrogate=model, device="cpu")
    ranked = model.rank(cands, device="cpu")[:3]
    assert list(pruned) == [f"c{i}" for i in ranked]
    assert [int(k[1:]) for k in pruned] == reference["prune/names"].tolist()
    assert [r.cycles for r in pruned.values()] == reference[
        "prune/cycles"].tolist()
    auto = place.evaluate_placements(g, NX, NY, names, cfgs=cfg,
                                     prune="surrogate", keep_top=2,
                                     surrogate_train=PRUNE_TRAIN,
                                     device="cpu")
    assert [int(k[1:]) for k in auto] == reference[
        "prune_auto/names"].tolist()
    assert [r.cycles for r in auto.values()] == reference[
        "prune_auto/cycles"].tolist()
    with pytest.raises(ValueError, match="unknown prune mode"):
        place.evaluate_placements(g, NX, NY, names, cfgs=cfg, prune="oracle",
                                  device="cpu")


def test_guide_checks(model):
    acfg = place.AnnealConfig(**SPEC_ACFG)
    other = wl.arrow_lu_graph(2, 5, 3, seed=1)
    with pytest.raises(ValueError, match="guide was built"):
        place.anneal_placement(other, NX, NY, acfg, guide=model, device="cpu")
    with pytest.raises(ValueError, match="guide was built"):
        place.anneal_placement(_graph(), NY, NX, acfg, guide=model,
                               device="cpu")
    with pytest.raises(ValueError, match="guide_every"):
        place.anneal_placement(_graph(), NX, NY, acfg, guide=model,
                               guide_every=0, device="cpu")
    with pytest.raises(ValueError, match="guide_every"):
        place.PlacementSpec(guide_every=0)
    with pytest.raises(ValueError, match="guide_train"):
        place.PlacementSpec(guide_train=1)
    # a guide passes the integer-quantized model unchanged
    from repro_torch.surrogate import delta as sd

    guide = sd.build_guide(model)
    a = place.anneal_placement(_graph(), NX, NY, dataclasses.replace(
        acfg, rounds=1), guide=guide, device="cpu")
    b = place.anneal_placement(_graph(), NX, NY, dataclasses.replace(
        acfg, rounds=1), guide=model, device="cpu")
    np.testing.assert_array_equal(a.node_pe, b.node_pe)
    assert a.cost_evals == b.cost_evals
