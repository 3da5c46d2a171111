"""The port's service keys (``repro_torch.service.hashing``) against the
reference's ``repro.service.hashing``, through one reference subprocess:
``config_token``, ``query_key`` and ``graph_digest`` equal for the default
config, every identity spelling (the stored ``IDENTITY``), search, guided,
multilevel and telemetry configs, the ``cost`` objective and a budget-folded
``effective_config``; keys that ignore ``engine`` and ``check_every`` and
stay the same under another ``PYTHONHASHSEED``; ``pareto_front`` on fixed
point lists; ``service_stream``'s names and graph tables; and the golden
constants of ``chip_smoke.py``'s service phase against
``BENCH_overlay.json``'s ``service`` rows.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_ref import ROOT, run_reference

from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.place import spec as place_spec
from repro_torch.place.spec import AnnealConfig, PlacementSpec  # noqa: F401
from repro_torch.service import (PlacementQuery, config_token,
                                 effective_config, graph_digest, pareto_front,
                                 query_key)
from repro_torch.telemetry.spec import TelemetrySpec  # noqa: F401

#: name -> config expression, evaluated in both packages (they export the
#: same names).
CONFIGS = {
    "default": "OverlayConfig()",
    "identity": 'OverlayConfig(placement="identity")',
    "spec_default": "OverlayConfig(placement=PlacementSpec())",
    "anneal": 'OverlayConfig(placement="anneal", max_cycles=200_000)',
    "anneal_seed7": ('OverlayConfig(placement=PlacementSpec(strategy="anneal",'
                     ' seed=7))'),
    "anneal_knobs": ('OverlayConfig(placement=PlacementSpec(strategy="anneal",'
                     ' init="clustered", metric="neg_slack", anneal='
                     'AnnealConfig(replicas=4, rounds=2, steps=64, '
                     't_max=32.0, seed=3)))'),
    "guided": ('OverlayConfig(placement=PlacementSpec(strategy="anneal", '
               'guide="surrogate"))'),
    "guided_knobs": ('OverlayConfig(placement=PlacementSpec(strategy="anneal",'
                     ' guide="surrogate", guide_margin=float("inf"), '
                     'guide_every=3, guide_train=8))'),
    "multilevel": 'OverlayConfig(placement="multilevel")',
    "multilevel_refine": ('OverlayConfig(placement=PlacementSpec(strategy='
                          '"multilevel", coarsen_ratio=8, refine=AnnealConfig('
                          'replicas=2, rounds=1, steps=32)))'),
    "clustered": 'OverlayConfig(placement="clustered")',
    "telemetry": "OverlayConfig(telemetry=TelemetrySpec())",
    "telemetry_partial": ("OverlayConfig(telemetry=TelemetrySpec(buckets=8, "
                          "bucket_cycles=64, links=False, sched=False))"),
    "inorder_priority": ('OverlayConfig(scheduler="inorder", eject_policy='
                         '"priority", eject_capacity=2, select_latency=4)'),
    "scan": 'OverlayConfig(scheduler="scan", max_cycles=123_456)',
}
#: (nx, ny, objective, budget) of each config's keys.
QUERIES = [(4, 4, "cycles", None), (2, 2, "cost", None),
           (4, 4, "cycles", 2048), (8, 8, "cost", 100_000)]
#: Fixed point lists for pareto_front: (cycles, num_pes) with ties.
POINTS = [
    [(937, 4), (900, 4), (418, 16), (420, 16), (510, 16), (300, 64),
     (300, 64), (250, 256), (260, 128), (900, 8)],
    [(5, 1)],
    [(10, 4), (10, 4), (10, 4), (9, 16), (9, 8), (11, 2)],
]
#: service_stream arguments whose names are compared.
STREAMS = [(32, 8, 0), (8, 3, 0), (5, 2, 3), (20, 8, 7), (1, 1, 0)]
#: The graph and grid of the key cases.
KEY_GRAPH = (2, 6, 4, 1)


def _points(i):
    return [{"name": f"p{j}", "cycles": c, "num_pes": n}
            for j, (c, n) in enumerate(POINTS[i])]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.place.spec import AnnealConfig, PlacementSpec
    from repro.service import (PlacementQuery, config_token,
                               effective_config, graph_digest, pareto_front,
                               query_key)
    from repro.service.explore import _placement_name
    from repro.telemetry.spec import TelemetrySpec

    g = wl.arrow_lu_graph(*{KEY_GRAPH[:3]!r}, seed={KEY_GRAPH[3]})
    for name, expr in {CONFIGS!r}.items():
        cfg = eval(expr)
        res[f"token/{{name}}"] = np.str_(config_token(cfg))
        keys = []
        for nx, ny, obj, budget in {QUERIES!r}:
            q = PlacementQuery(graph=g, nx=nx, ny=ny, objective=obj,
                               budget=budget, cfg=cfg)
            eff = effective_config(q)
            keys.append(query_key(g, nx, ny, eff, obj))
            res[f"eff/{{name}}/{{nx}}x{{ny}}/{{obj}}/{{budget}}"] = np.str_(
                config_token(eff))
        res[f"keys/{{name}}"] = np.asarray(keys, dtype=np.int64)
    for i, pts in enumerate({POINTS!r}):
        points = [dict(name=f"p{{j}}", cycles=c, num_pes=n)
                  for j, (c, n) in enumerate(pts)]
        res[f"front/{{i}}"] = np.asarray([p["name"] for p in
                                          pareto_front(points)])
        res[f"front_swapped/{{i}}"] = np.asarray(
            [p["name"] for p in pareto_front(points, ("num_pes", "cycles"))])
    for args in {STREAMS!r}:
        stream = wl.service_stream(*args)
        res[f"stream/{{args}}"] = np.asarray([n for n, _ in stream])
    for name, sg in wl.service_stream(8, 8, 0):
        res[f"digest/{{name}}"] = np.frombuffer(graph_digest(sg), np.uint8)
        for f in ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
                  "initial_values"):
            res[f"graph/{{name}}/{{f}}"] = getattr(sg, f)
    for p in ("identity", None, "anneal", PlacementSpec(strategy="anneal")):
        res[f"pname/{{p!r}}"] = np.str_(_placement_name(p))
    """
    return run_reference(tmp_path_factory, "service_keys", body)


def _graph():
    return wl.arrow_lu_graph(*KEY_GRAPH[:3], seed=KEY_GRAPH[3])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_token_and_keys_equal_reference(reference, name):
    """The F2 gate: every spelling encodes to the reference's text and
    key, identity included, budget folded or not."""
    cfg = eval(CONFIGS[name])
    assert config_token(cfg) == str(reference[f"token/{name}"])
    g = _graph()
    keys = []
    for nx, ny, obj, budget in QUERIES:
        q = PlacementQuery(graph=g, nx=nx, ny=ny, objective=obj,
                           budget=budget, cfg=cfg)
        eff = effective_config(q)
        assert config_token(eff) == str(
            reference[f"eff/{name}/{nx}x{ny}/{obj}/{budget}"])
        keys.append(query_key(g, nx, ny, eff, obj))
    assert keys == reference[f"keys/{name}"].tolist()


def test_identity_spellings_share_one_key():
    g = _graph()
    keys = {query_key(g, 4, 4, OverlayConfig(placement=p))
            for p in (None, "identity", PlacementSpec(), place_spec.IDENTITY)}
    assert len(keys) == 1
    assert OverlayConfig().placement is place_spec.IDENTITY


def test_budget_folds_into_search_specs_only():
    g = _graph()
    q = PlacementQuery(graph=g, nx=4, ny=4, budget=2048,
                       cfg=OverlayConfig(placement="anneal"))
    spec = effective_config(q).placement
    assert spec.anneal == AnnealConfig(rounds=1)       # 2048 // (8 * 512) -> 1
    q = PlacementQuery(graph=g, nx=4, ny=4, budget=10 * 8 * 512,
                       cfg=OverlayConfig(placement="anneal"))
    assert effective_config(q).placement.anneal.rounds == 10
    q = PlacementQuery(graph=g, nx=4, ny=4, budget=2048)
    assert effective_config(q).placement is place_spec.IDENTITY


@pytest.mark.parametrize("variant", [
    dict(engine="select"), dict(engine="megakernel"), dict(engine="tensor"),
    dict(engine="jnp"), dict(check_every=1), dict(check_every=7),
    dict(engine="megakernel", check_every=32)])
def test_keys_ignore_execution_knobs(variant):
    g = _graph()
    cfg = OverlayConfig(placement="anneal", max_cycles=200_000)
    assert (query_key(g, 4, 4, dataclasses.replace(cfg, **variant))
            == query_key(g, 4, 4, cfg))


def test_keys_discriminate_model_knobs():
    g = _graph()
    cfg = OverlayConfig(placement="anneal", max_cycles=200_000)
    base = query_key(g, 4, 4, cfg)
    perturbed = dataclasses.replace(
        g, initial_values=g.initial_values + np.float32(1))
    others = [query_key(perturbed, 4, 4, cfg), query_key(g, 4, 8, cfg),
              query_key(g, 4, 4, cfg, "cost"),
              query_key(g, 4, 4, dataclasses.replace(cfg, scheduler="inorder")),
              query_key(g, 4, 4, dataclasses.replace(cfg, placement=None))]
    assert base not in others and len(set(others)) == len(others)
    assert graph_digest(perturbed) != graph_digest(g)


KEY_SCRIPT = """
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.service import query_key
g = wl.arrow_lu_graph(2, 6, 4, seed=1)
print(query_key(g, 4, 4, OverlayConfig(placement="anneal",
                                       max_cycles=200_000)))
print(query_key(g, 2, 2, OverlayConfig(), "cost"))
"""


@pytest.mark.parametrize("hashseed", ["0", "12345"])
def test_keys_stable_across_processes(reference, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=hashseed,
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", KEY_SCRIPT], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    got = [int(v) for v in out.stdout.split()]
    assert got == [int(reference["keys/anneal"][0]),
                   int(reference["keys/default"][1])]


def test_explicit_array_has_no_key():
    g = _graph()
    cfg = OverlayConfig(placement=np.zeros(g.num_nodes, dtype=np.int32))
    with pytest.raises(TypeError, match="PlacementSpec"):
        config_token(cfg)
    with pytest.raises(TypeError, match="PlacementSpec"):
        effective_config(PlacementQuery(graph=g, nx=4, ny=4, cfg=cfg))


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_pareto_front_equal_reference(reference, i):
    pts = _points(i)
    assert ([p["name"] for p in pareto_front(pts)]
            == reference[f"front/{i}"].tolist())
    assert ([p["name"] for p in pareto_front(pts, ("num_pes", "cycles"))]
            == reference[f"front_swapped/{i}"].tolist())


def test_placement_names_equal_reference(reference):
    from repro_torch.service.explore import _placement_name

    for p in ("identity", None, "anneal", PlacementSpec(strategy="anneal")):
        assert _placement_name(p) == str(reference[f"pname/{p!r}"])


@pytest.mark.parametrize("args", STREAMS)
def test_service_stream_names_equal_reference(reference, args):
    assert ([n for n, _ in wl.service_stream(*args)]
            == reference[f"stream/{args}"].tolist())


def test_service_stream_graphs_equal_reference(reference):
    for name, g in wl.service_stream(8, 8, 0):
        for f in ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
                  "initial_values"):
            want = reference[f"graph/{name}/{f}"]
            got = getattr(g, f)
            assert got.dtype == want.dtype, (name, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{f}")
        assert (np.frombuffer(graph_digest(g), np.uint8).tolist()
                == reference[f"digest/{name}"].tolist())


@pytest.mark.parametrize("args", [(3, 4, 0), (0, 0, 0), (9, 9, 0)])
def test_service_stream_rejects(args):
    with pytest.raises(ValueError):
        wl.service_stream(*args)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_service_goldens_equal_bench():
    """The service phase's constants are BENCH_overlay.json's ``service``
    rows: the 8 cycles_anneal (cached = fresh), the 2 frontier points, the
    stream's counters and the swept-point count."""
    cs = _chip_smoke()
    rows = {r["name"]: r for r in json.loads(
        (ROOT / "BENCH_overlay.json").read_text())["service"]["rows"]}
    anneal = {n[len("service_"):]: r for n, r in rows.items()
              if "cycles_anneal" in r}
    assert cs.SERVICE_GOLDENS == {n: r["cycles_anneal"]
                                  for n, r in anneal.items()}
    assert all(r["svc_cycles_cached"] == r["svc_cycles_fresh"]
               == r["cycles_anneal"] for r in anneal.values())
    frontier = {n[len("service_frontier_"):]: r["cycles_frontier"]
                for n, r in rows.items() if "cycles_frontier" in r}
    assert cs.SERVICE_FRONTIER == frontier
    stream = rows["service_stream"]
    assert cs.SERVICE_COUNTERS == {
        "queries": stream["queries"], "distinct": stream["distinct"],
        "hits": stream["svc_hits"], "misses": stream["svc_misses"],
        "simulations": stream["svc_simulations"],
        "anneals": stream["svc_anneals"],
        "batched_anneals": stream["svc_batched_anneals"],
        "hit_rate": stream["hit_rate"]}
    front = rows["service_frontier"]
    assert (cs.SERVICE_FRONTIER_POINTS, cs.SERVICE_SWEPT_POINTS) == (
        front["svc_frontier_points"], front["svc_swept_points"])
    assert len(cs.SERVICE_FRONTIER) == cs.SERVICE_FRONTIER_POINTS
