"""The port's placement front door (``repro_torch.place.api`` and
``OverlayConfig(placement=...)``) against the reference's, on the CPU,
exactly: ``resolve`` for every static strategy, a spec and the search
strategies at small budgets; packed graph memories; ``evaluate_placements``
and ``simulate_placements`` cycles under one config and a sweep;
``repro_torch.run`` of a raw graph under every kind of placement, solo and
batched; and the config hillclimb. The BENCH ``placement`` rows are in
``tests/test_torch_place_rows.py``.
"""
import numpy as np
import pytest

from _torch_ref import RESULT_KEYS, run_reference

import repro_torch
from repro_torch import place
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.place.spec import (STATIC_STRATEGIES, AnnealConfig,
                                    PlacementArray, PlacementSpec)

GRAPH = (2, 5, 3)        # arrow_lu_graph args of the small cases
GRID = (4, 4)
SMALL_ANNEAL = dict(replicas=4, rounds=2, steps=16, seed=3)
#: name -> PlacementSpec keywords (searches at small budgets)
SPECS = {
    "seeded_random": dict(strategy="random", seed=5),
    "identity_slack": dict(strategy="identity", metric="neg_slack"),
    "anneal": dict(strategy="anneal", anneal=SMALL_ANNEAL),
    "anneal_warm": dict(strategy="anneal", init="clustered",
                        anneal=SMALL_ANNEAL),
    "multilevel": dict(strategy="multilevel", coarsen_ratio=8,
                       anneal=SMALL_ANNEAL,
                       refine=dict(replicas=2, rounds=1, steps=16, seed=3)),
}
SWEEP = [dict(scheduler="ooo"), dict(scheduler="ooo", select_latency=2),
         dict(scheduler="ooo", max_cycles=150)]
HILL_SPACE = {"placement": ["round_robin", "clustered"],
              "scheduler": ["ooo", "inorder"],
              "select_latency": [None, 2], "eject_capacity": [1]}


def _spec(kw):
    kw = dict(kw)
    for k in ("anneal", "refine"):
        if k in kw:
            kw[k] = AnnealConfig(**kw[k])
    return PlacementSpec(**kw)


def _graph():
    return wl.arrow_lu_graph(*GRAPH, seed=3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import repro
    from repro import place
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig

    def spec(kw):
        kw = dict(kw)
        for k in ("anneal", "refine"):
            if k in kw:
                kw[k] = place.AnnealConfig(**kw[k])
        return place.PlacementSpec(**kw)

    g = wl.arrow_lu_graph(*{GRAPH!r}, seed=3)
    nx, ny = {GRID!r}
    for s in {STATIC_STRATEGIES!r}:
        res["resolve/" + s] = place.resolve(g, nx, ny, s)
    res["resolve/None"] = place.resolve(g, nx, ny, None)
    specs = {{k: spec(v) for k, v in {SPECS!r}.items()}}
    for k, s in specs.items():
        res["resolve/" + k] = place.resolve(g, nx, ny, s)
        gm = place.graph_memory(g, nx, ny, s)
        for f in ("node_pe", "node_slot", "opcode", "fo_base", "e_dst_slot"):
            res[f"gm/{{k}}/{{f}}"] = np.asarray(getattr(gm, f))
    cands = {{"identity": None, "blocked": "blocked",
              "anneal": specs["anneal"], "multilevel": specs["multilevel"],
              "array": np.arange(g.num_nodes, dtype=np.int32) % 5}}
    one = place.evaluate_placements(g, nx, ny, cands,
                                    cfgs=OverlayConfig(max_cycles=200_000))
    for k, r in one.items():
        for f, v in sim_result(r).items():
            res[f"eval/{{k}}/{{f}}"] = np.asarray(v)
    sweep = place.evaluate_placements(
        g, nx, ny, cands, cfgs=[OverlayConfig(**kw) for kw in {SWEEP!r}])
    for k, rs in sweep.items():
        for b, r in enumerate(rs):
            res[f"sweep/{{k}}/{{b}}"] = np.asarray([r.cycles, r.deflections])
    sims = place.simulate_placements(
        g, nx, ny, [place.resolve(g, nx, ny, s) for s in ("random",
                                                           "clustered")],
        OverlayConfig(scheduler="scan"))
    res["simulate"] = np.asarray([r.cycles for r in sims])
    for k in ("random", "anneal", "multilevel"):
        r = repro.run(g, OverlayConfig(placement=cands.get(k, k)
                                       if k != "random" else "random"),
                      nx=nx, ny=ny)
        res["run/" + k] = np.asarray([r.cycles, r.deflections])
    hc = place.config_hillclimb(g, nx, ny, space={HILL_SPACE!r})
    res["hill/best"] = np.asarray(hc["best_cycles"])
    res["hill/evals"] = np.asarray(hc["evaluations"])
    res["hill/trajectory"] = np.asarray(
        [t["cycles"] for t in hc["trajectory"]])
    lmax, emax = place.shape_class(
        [(g, place.resolve(g, nx, ny, s)) for s in ("random", "blocked")],
        nx, ny)
    res["shape_class"] = np.asarray([lmax, emax])
    """
    return run_reference(tmp_path_factory, "place_api", body,
                         legacy_prng=True)


def test_resolve_static_strategies(reference):
    g = _graph()
    for s in STATIC_STRATEGIES:
        got = place.resolve(g, *GRID, s)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, reference["resolve/" + s],
                                      err_msg=s)
    np.testing.assert_array_equal(place.resolve(g, *GRID, None),
                                  reference["resolve/None"])
    arr = np.arange(g.num_nodes) % 3
    np.testing.assert_array_equal(place.resolve(g, *GRID, arr), arr)
    np.testing.assert_array_equal(
        place.resolve(g, *GRID, PlacementArray(arr)), arr)


@pytest.mark.parametrize("name", SPECS)
def test_resolve_specs_and_graph_memory(reference, name):
    g = _graph()
    s = _spec(SPECS[name])
    np.testing.assert_array_equal(place.resolve(g, *GRID, s, device="cpu"),
                                  reference["resolve/" + name])
    gm = place.graph_memory(g, *GRID, s, device="cpu")
    for f in ("node_pe", "node_slot", "opcode", "fo_base", "e_dst_slot"):
        np.testing.assert_array_equal(getattr(gm, f),
                                      reference[f"gm/{name}/{f}"], err_msg=f)


def _candidates(g):
    return {"identity": None, "blocked": "blocked",
            "anneal": _spec(SPECS["anneal"]),
            "multilevel": _spec(SPECS["multilevel"]),
            "array": np.arange(g.num_nodes, dtype=np.int32) % 5}


def test_evaluate_placements_one_config(reference):
    g = _graph()
    got = place.evaluate_placements(g, *GRID, _candidates(g),
                                    cfgs=OverlayConfig(max_cycles=200_000),
                                    device="cpu")
    assert list(got) == list(_candidates(g))
    for k, r in got.items():
        assert r.done
        for f in RESULT_KEYS:
            want = reference[f"eval/{k}/{f}"]
            if f == "values":
                np.testing.assert_array_equal(r.values, want)
            else:
                assert getattr(r, f) == want.item(), (k, f)


def test_evaluate_placements_sweep_and_simulate(reference):
    g = _graph()
    got = place.evaluate_placements(
        g, *GRID, _candidates(g), cfgs=[OverlayConfig(**kw) for kw in SWEEP],
        device="cpu")
    for k, rs in got.items():
        assert len(rs) == len(SWEEP)
        for b, r in enumerate(rs):
            assert [r.cycles, r.deflections] == reference[
                f"sweep/{k}/{b}"].tolist(), (k, b)
    sims = place.simulate_placements(
        g, *GRID, [place.resolve(g, *GRID, s) for s in ("random",
                                                         "clustered")],
        OverlayConfig(scheduler="scan"), device="cpu")
    assert [r.cycles for r in sims] == reference["simulate"].tolist()


def test_run_with_placement_solo_and_batched(reference):
    """``repro_torch.run`` of a raw graph places it per ``cfg.placement``
    (a name, a spec or an array); a batch shares it."""
    g = _graph()
    cands = _candidates(g)
    for k in ("random", "anneal", "multilevel"):
        cfg = OverlayConfig(placement=cands.get(k, "random"))
        r = repro_torch.run(g, cfg, nx=GRID[0], ny=GRID[1], device="cpu")
        assert [r.cycles, r.deflections] == reference["run/" + k].tolist(), k
    arr = cands["array"]
    solo = repro_torch.run(g, OverlayConfig(placement=arr), nx=GRID[0],
                           ny=GRID[1], device="cpu")
    assert solo.cycles == int(reference["eval/array/cycles"])
    batch = repro_torch.run(
        g, batch=[OverlayConfig(placement=arr, **kw) for kw in SWEEP],
        nx=GRID[0], ny=GRID[1], device="cpu")
    assert [[r.cycles, r.deflections] for r in batch] == [
        reference[f"sweep/array/{b}"].tolist() for b in range(len(SWEEP))]


def test_overlay_config_placement_forms():
    """Every name, a spec and an array are taken and normalised: the
    identity spellings are stored as None, two spellings of one layout
    compare and hash equal, an array becomes a read-only PlacementArray."""
    for s in STATIC_STRATEGIES + ("anneal", "multilevel"):
        cfg = OverlayConfig(placement=s)
        if s == "identity":
            assert cfg.placement is None
        else:
            assert cfg.placement == PlacementSpec(strategy=s)
            assert cfg == OverlayConfig(placement=PlacementSpec(strategy=s))
            assert hash(cfg) == hash(OverlayConfig(
                placement=PlacementSpec(strategy=s)))
    assert OverlayConfig(placement=PlacementSpec()).placement is None
    arr = np.arange(10, dtype=np.int64) % 4
    cfg = OverlayConfig(placement=arr)
    assert isinstance(cfg.placement, PlacementArray)
    assert cfg.placement.node_pe.dtype == np.int32
    assert not cfg.placement.node_pe.flags.writeable
    arr[0] = 3                        # the config holds its own copy
    assert cfg.placement.node_pe[0] == 0
    assert cfg == OverlayConfig(placement=np.arange(10) % 4)
    assert hash(cfg) == hash(OverlayConfig(placement=np.arange(10) % 4))
    assert cfg != OverlayConfig(placement=np.arange(10) % 3)
    assert OverlayConfig(placement=cfg.placement) == cfg
    with pytest.raises(ValueError, match="unknown placement strategy"):
        OverlayConfig(placement="spiral")
    with pytest.raises(TypeError, match="placement must be"):
        OverlayConfig(placement=3)
    with pytest.raises(ValueError, match="guide"):
        PlacementSpec(strategy="random", guide="surrogate")
    guided = PlacementSpec(strategy="anneal", guide="surrogate")
    assert OverlayConfig(placement=guided).placement == guided


def test_not_ported_options_raise():
    g = _graph()
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        place.evaluate_placements(g, *GRID, {"a": None}, mesh=object(),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        place.simulate_placements(g, *GRID, [place.resolve(g, *GRID)],
                                  mesh=object(), device="cpu")
    # prune= and guide_model= work (the surrogate is ported): the pruned
    # evaluation simulates the model's best-ranked candidates only, with the
    # full evaluation's cycles, and a guided spec's search takes the model.
    from repro_torch import surrogate

    sampled = surrogate.sample_placements(g, *GRID, 6, seed=1)
    model = surrogate.fit(g, *GRID, sampled, 1000 + np.arange(6) ** 2,
                          device="cpu")
    cands = {"a": None, "b": "clustered", "c": sampled[3]}
    full = place.evaluate_placements(g, *GRID, cands, device="cpu")
    pruned = place.evaluate_placements(g, *GRID, cands, prune="surrogate",
                                       keep_top=2, surrogate=model,
                                       device="cpu")
    order = model.rank(np.stack([place.resolve(g, *GRID, v) for v in
                                 cands.values()]), device="cpu")
    assert list(pruned) == [list(cands)[i] for i in order[:2]]
    assert all(r.cycles == full[k].cycles for k, r in pruned.items())
    spec = PlacementSpec(strategy="anneal", guide="surrogate",
                         anneal=AnnealConfig(**SMALL_ANNEAL))
    np.testing.assert_array_equal(
        place.resolve(g, *GRID, spec, guide_model=model, device="cpu"),
        place.anneal_placement(g, *GRID, AnnealConfig(**SMALL_ANNEAL),
                               guide=model, device="cpu").node_pe)
    with pytest.raises(ValueError, match="wants_criticality_order"):
        place.evaluate_placements(
            g, *GRID, {"a": None}, cfgs=[OverlayConfig(scheduler="ooo"),
                                         OverlayConfig(scheduler="inorder")],
            device="cpu")


def test_config_hillclimb_and_shape_class(reference):
    g = _graph()
    hc = place.config_hillclimb(g, *GRID, space=HILL_SPACE, device="cpu")
    assert hc["best_cycles"] == int(reference["hill/best"])
    assert hc["evaluations"] == int(reference["hill/evals"])
    assert [t["cycles"] for t in hc["trajectory"]] == reference[
        "hill/trajectory"].tolist()
    pes = [place.resolve(g, *GRID, s) for s in ("random", "blocked")]
    assert list(place.shape_class([(g, p) for p in pes], *GRID)) == reference[
        "shape_class"].tolist()
    gms = place.uniform_graph_memories(g, *GRID, pes)
    assert len({(m.lmax, m.emax) for m in gms}) == 1

