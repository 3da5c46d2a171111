"""The port's placement service (``repro_torch.service``) on the CPU against
the reference's ``repro.service`` (one subprocess on the non-partitionable
Threefry layout, the BENCH goldens' layout):

  * a small stream (``service_stream(8, 3, seed=0)``, 4x4, budget 2048,
    ``placement="anneal"``): every answer's placement, cycles and stats,
    the hit/miss pattern and the counters equal the reference's, and hits
    run zero simulations;
  * the batched anneal fan-out (three seeds in one ``run_batch``) equal to
    the reference's rows and to the port's solo queries;
  * the ``cost`` objective: zero simulations, the reference's integer cost;
  * within-batch duplicates answered once; ``ResultCache`` LRU evictions;
    disk persistence both ways (an entry the reference writes loads in the
    port, and one the port writes loads in the reference).

Every service here has a fresh temporary cache directory or none, so no
answer comes from an entry left by another run.
"""
import numpy as np
import pytest

from _torch_ref import run_reference

from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.place import PlacementSpec
from repro_torch.service import (PlacementQuery, PlacementService,
                                 ResultCache, service_cache_dir)
from repro_torch.service import cache as svc_cache

NX = NY = 4
BUDGET = 2048
STREAM = (8, 3, 0)
SEEDS = (0, 1, 2)
MAX_CYCLES = 200_000
#: cost-objective placements: the reference's integer cost of each.
COST_PLACEMENTS = ("anneal", "identity", "clustered")
STAT_KEYS = ("busy_cycles", "deflections", "delivered", "eject_deflections",
             "noc_deflections")


def _q(g, placement="anneal", objective="cycles", budget=BUDGET, **kw):
    return PlacementQuery(graph=g, nx=NX, ny=NY, objective=objective,
                          budget=budget,
                          cfg=OverlayConfig(placement=placement,
                                            max_cycles=MAX_CYCLES, **kw))


def _g0():
    return wl.service_stream(*STREAM)[0][1]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Fresh cache directories: one the reference writes, and one the port
    writes before the reference's subprocess reads it."""
    ref_dir = tmp_path_factory.mktemp("ref_cache")
    port_dir = tmp_path_factory.mktemp("port_cache")
    svc = PlacementService(cache_dir=str(port_dir), device="cpu")
    first = svc.query(_q(_g0(), placement="identity"))
    return ref_dir, port_dir, first


@pytest.fixture(scope="module")
def reference(tmp_path_factory, dirs):
    ref_dir, port_dir, _ = dirs
    body = f"""
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.place import PlacementSpec
    from repro.service import PlacementQuery, PlacementService

    def q(g, placement="anneal", objective="cycles"):
        return PlacementQuery(graph=g, nx={NX}, ny={NY}, objective=objective,
                              budget={BUDGET}, cfg=OverlayConfig(
                                  placement=placement,
                                  max_cycles={MAX_CYCLES}))

    def answer(key, r):
        res[key + "/node_pe"] = np.asarray(r.node_pe)
        res[key + "/cached"] = np.asarray(r.cached)
        res[key + "/key"] = np.asarray(r.key, dtype=np.int64)
        if r.cycles is not None:
            res[key + "/cycles"] = np.asarray(r.cycles)
        if r.cost is not None:
            res[key + "/cost"] = np.asarray(r.cost)
        for k, v in r.stats.items():
            res[key + "/stats/" + k] = np.asarray(v)

    def report(key, svc):
        for k, v in svc.report().items():
            res[key + "/report/" + k] = np.asarray(v)

    stream = wl.service_stream(*{STREAM!r})
    svc = PlacementService()
    for i, (name, g) in enumerate(stream):
        answer(f"stream/{{i}}", svc.query(q(g)))
    report("stream", svc)

    g0 = stream[0][1]
    mk = lambda s: q(g0, PlacementSpec(strategy="anneal", seed=s))
    svc = PlacementService()
    for s, r in zip({SEEDS!r}, svc.run_batch([mk(s) for s in {SEEDS!r}])):
        answer(f"batch/{{s}}", r)
    report("batch", svc)

    for p in {COST_PLACEMENTS!r}:
        svc = PlacementService()
        answer(f"cost/{{p}}", svc.query(q(g0, p, "cost")))
        report(f"cost/{{p}}", svc)

    svc = PlacementService(cache_dir={str(ref_dir)!r})
    answer("ref_disk", svc.query(q(g0, "anneal")))
    svc = PlacementService(cache_dir={str(port_dir)!r})
    answer("port_disk", svc.query(q(g0, "identity")))
    report("port_disk", svc)
    """
    return run_reference(tmp_path_factory, "service", body, legacy_prng=True)


def _assert_answer(r, ref, key):
    np.testing.assert_array_equal(r.node_pe, ref[f"{key}/node_pe"])
    assert r.node_pe.dtype == np.int32
    assert r.key == int(ref[f"{key}/key"])
    if f"{key}/cycles" in ref:
        assert r.cycles == int(ref[f"{key}/cycles"]), key
    else:
        assert r.cycles is None
    if f"{key}/cost" in ref:
        assert r.cost == int(ref[f"{key}/cost"]) and isinstance(r.cost, int)
    else:
        assert r.cost is None
    assert r.stats == {k[len(key) + 7:]: int(v) for k, v in ref.items()
                       if k.startswith(f"{key}/stats/")}


def _assert_report(svc, ref, key):
    want = {k[len(key) + 8:]: v.item() for k, v in ref.items()
            if k.startswith(f"{key}/report/")}
    assert svc.report() == want


@pytest.fixture(scope="module")
def stream_run():
    svc = PlacementService(device="cpu")
    answers, sims = [], []
    for _, g in wl.service_stream(*STREAM):
        before = svc.counters["simulations"]
        answers.append(svc.query(_q(g)))
        sims.append(svc.counters["simulations"] - before)
    return svc, answers, sims


@pytest.mark.parametrize("i", range(STREAM[0]))
def test_stream_answer_equal_reference(reference, stream_run, i):
    svc, answers, sims = stream_run
    r = answers[i]
    _assert_answer(r, reference, f"stream/{i}")
    assert r.cached == bool(reference[f"stream/{i}/cached"])
    assert sims[i] == (0 if r.cached else 1)   # hits run zero simulations
    assert set(r.stats) == set(STAT_KEYS)


def test_stream_counters_equal_reference(reference, stream_run):
    svc, answers, _ = stream_run
    _assert_report(svc, reference, "stream")
    rep = svc.report()
    assert (rep["cache_hits"], rep["cache_misses"], rep["simulations"],
            rep["anneals"], rep["batched_anneals"]) == (5, 3, 3, 3, 0)
    names = [n for n, _ in wl.service_stream(*STREAM)]
    first = {}
    for n, r in zip(names, answers):
        if n in first:
            assert r.cached and r.cycles == first[n].cycles
            np.testing.assert_array_equal(r.node_pe, first[n].node_pe)
        else:
            first[n] = r
    # the BENCH service rows' cycles_anneal of these three graphs
    assert [r.cycles for r in first.values()] == [510, 510, 679]


def test_batched_fan_out_equal_reference_and_solo(reference):
    g0 = _g0()
    mk = lambda s: _q(g0, PlacementSpec(strategy="anneal", seed=s))
    svc = PlacementService(device="cpu")
    batched = svc.run_batch([mk(s) for s in SEEDS])
    _assert_report(svc, reference, "batch")
    assert svc.counters["batched_anneals"] == len(SEEDS)
    for s, b in zip(SEEDS, batched):
        _assert_answer(b, reference, f"batch/{s}")
        solo = PlacementService(device="cpu").query(mk(s))
        np.testing.assert_array_equal(b.node_pe, solo.node_pe)
        assert (b.cycles, b.stats) == (solo.cycles, solo.stats)


@pytest.mark.parametrize("placement", COST_PLACEMENTS)
def test_cost_objective_equal_reference(reference, placement):
    svc = PlacementService(device="cpu")
    r = svc.query(_q(_g0(), placement, "cost"))
    assert svc.counters["simulations"] == 0 and r.cycles is None
    _assert_answer(r, reference, f"cost/{placement}")
    _assert_report(svc, reference, f"cost/{placement}")


def test_hit_zero_simulations_and_duplicates_once():
    g0 = _g0()
    svc = PlacementService(device="cpu")
    a, b = svc.run_batch([_q(g0, "identity"), _q(g0, "identity")])
    assert a.key == b.key and not a.cached and not b.cached
    assert svc.counters["simulations"] == 1
    assert a.cycles == b.cycles and a.stats == b.stats
    np.testing.assert_array_equal(a.node_pe, b.node_pe)
    c = svc.query(_q(g0, "identity", engine="megakernel", check_every=5))
    assert c.cached and svc.counters["simulations"] == 1
    assert (c.key, c.cycles, c.stats) == (a.key, a.cycles, a.stats)
    rep = svc.report()
    assert (rep["cache_hits"], rep["cache_misses"], rep["queries"]) == (1, 1, 3)


def test_result_cache_lru_evictions():
    """Cost queries on static placements run no search and no simulation,
    so the LRU is exercised at no cost."""
    cache = ResultCache(capacity=2)
    svc = PlacementService(cache=cache, device="cpu")
    graphs = [wl.arrow_lu_graph(b, 6, 4, seed=1) for b in (2, 3, 4)]
    for g in graphs:
        assert not svc.query(_q(g, "identity", "cost")).cached
    assert (cache.evictions, len(cache)) == (1, 2)
    assert svc.query(_q(graphs[2], "identity", "cost")).cached
    assert not svc.query(_q(graphs[0], "identity", "cost")).cached
    assert cache.evictions == 2
    rep = cache.report()
    assert (rep["hits"], rep["misses"], rep["entries"]) == (1, 4, 2)
    assert rep["hit_rate"] == 0.2
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=0)


def test_disk_persistence_in_the_port(tmp_path):
    g0 = _g0()
    d = str(tmp_path / "svc")
    a = PlacementService(cache_dir=d, device="cpu").query(_q(g0, "identity"))
    svc = PlacementService(cache_dir=d, device="cpu")
    b = svc.query(_q(g0, "identity"))
    assert b.cached and svc.counters["simulations"] == 0
    assert svc.cache.disk_hits == 1
    assert (b.cycles, b.stats, b.key) == (a.cycles, a.stats, a.key)
    np.testing.assert_array_equal(b.node_pe, a.node_pe)
    entry = svc_cache._entry_path(d, a.key)
    assert entry.endswith(f"q{a.key & 0xFFFFFFFFFFFFFFFF:016x}.npz")


def test_reference_entry_loads_in_the_port(reference, dirs):
    ref_dir = dirs[0]
    svc = PlacementService(cache_dir=str(ref_dir), device="cpu")
    r = svc.query(_q(_g0()))
    assert r.cached and svc.counters["simulations"] == 0
    assert svc.counters["anneals"] == 0 and svc.cache.disk_hits == 1
    _assert_answer(r, reference, "ref_disk")


def test_port_entry_loads_in_the_reference(reference, dirs):
    first = dirs[2]
    assert bool(reference["port_disk/cached"])
    assert int(reference["port_disk/report/simulations"]) == 0
    assert int(reference["port_disk/report/cache_disk_hits"]) == 1
    assert first.cycles == int(reference["port_disk/cycles"])
    np.testing.assert_array_equal(first.node_pe,
                                  reference["port_disk/node_pe"])
    assert first.key == int(reference["port_disk/key"])


def test_service_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_SERVICE_CACHE", str(tmp_path))
    assert service_cache_dir() == str(tmp_path)
    monkeypatch.delenv("REPRO_SERVICE_CACHE")
    assert service_cache_dir().endswith("experiments/service_cache")


def test_query_validation():
    g0 = _g0()
    for kw in (dict(objective="area"), dict(nx=0), dict(budget=0)):
        with pytest.raises(ValueError):
            PlacementQuery(**{**dict(graph=g0, nx=NX, ny=NY), **kw})
