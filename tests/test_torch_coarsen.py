"""The port's multilevel placement (``repro_torch.place.coarsen``) against
the reference's, on the CPU, exactly: the criticality-aware clustering at
several ratios and metrics, the quotient tables, the whole coarsen ->
anneal -> refine pipeline at small budgets (with and without refinement),
the identity clustering equal to the plain annealer, and ``fig1_full``'s
graph bytes and cache name at the reference's small calibration size.
"""
import os

import numpy as np
import pytest

from _torch_ref import run_reference

from repro_torch.core import workloads as wl
from repro_torch.place import anneal as pa
from repro_torch.place import coarsen
from repro_torch.place.spec import AnnealConfig

#: name -> (generator, args, ratio, metric, crit_scale)
CLUSTERINGS = {
    "arrow_r8": ("arrow_lu_graph", (2, 8, 6), 8, "height", 3),
    "arrow_r32_slack": ("arrow_lu_graph", (2, 8, 6), 32, "neg_slack", 3),
    "banded_r4": ("banded_lu_graph", (30, 4), 4, "height", 5),
    "layered_r1": ("layered_dag", (5, 8), 1, "height", 3),
    "layered_r64": ("layered_dag", (5, 8), 64, "fanout_height", 2),
}
#: name -> (arrow args, grid, ratio, coarse keywords, refine keywords or
#: None for no refinement, or "auto")
PIPELINES = {
    "ml_auto": ((2, 8, 6), (4, 4), 16, dict(replicas=4, rounds=4, steps=32,
                                            seed=0), "auto"),
    "ml_refine": ((2, 8, 6), (8, 8), 32, dict(replicas=8, rounds=2, steps=16,
                                              seed=1),
                  dict(replicas=2, rounds=2, steps=16, seed=1)),
    "ml_none": ((2, 4, 3), (2, 2), 8, dict(replicas=2, rounds=3, steps=8,
                                           seed=4), None),
}
IDENTITY = ((2, 4, 3), (4, 4), dict(replicas=4, rounds=2, steps=16, seed=2))
FIG1_SMALL = 1_000


def _graph(fn, args):
    return getattr(wl, fn)(*args, seed=3)


def _refine(kw):
    return kw if kw in (None, "auto") else AnnealConfig(**kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cache = tmp_path_factory.mktemp("fig1_cache")
    body = f"""
    import os
    from repro import place
    from repro.core import workloads as wl
    from repro.place import coarsen

    for name, (fn, args, ratio, metric, cs) in {CLUSTERINGS!r}.items():
        g = getattr(wl, fn)(*args, seed=3)
        cl = coarsen.cluster_nodes(g, ratio, metric=metric, crit_scale=cs)
        res[name + "/clusters"] = cl
        for k, v in zip(("src", "dst", "w_edge", "w_node"),
                        coarsen.quotient_tables(g, cl, metric=metric,
                                                crit_scale=cs)):
            res[f"{{name}}/{{k}}"] = v
    for name, (args, (nx, ny), ratio, kw, rkw) in {PIPELINES!r}.items():
        g = wl.arrow_lu_graph(*args, seed=3)
        refine = rkw if rkw in (None, "auto") else place.AnnealConfig(**rkw)
        ml = coarsen.multilevel_anneal(g, nx, ny, place.AnnealConfig(**kw),
                                       ratio=ratio, refine=refine)
        res[name + "/node_pe"] = ml.node_pe
        res[name + "/clusters"] = ml.clusters
        res[name + "/num_clusters"] = np.int64(ml.num_clusters)
        res[name + "/cost"] = np.int64(ml.cost)
        res[name + "/projected_cost"] = np.int64(ml.projected_cost)
        res[name + "/coarse_pe"] = ml.coarse.node_pe
        res[name + "/coarse_costs"] = ml.coarse.replica_costs
        res[name + "/coarse_init"] = np.int64(ml.coarse.init_cost)
        if ml.refined is not None:
            res[name + "/refined_costs"] = ml.refined.replica_costs
    g = wl.fig1_full(target_nodes={FIG1_SMALL}, seed=0,
                     cache_dir={str(cache)!r})
    for f in ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
              "initial_values"):
        res["fig1/" + f] = np.asarray(getattr(g, f))
    res["fig1/cache"] = np.asarray(sorted(os.listdir({str(cache)!r})))
    """
    return run_reference(tmp_path_factory, "coarsen", body, legacy_prng=True)


@pytest.mark.parametrize("name", CLUSTERINGS)
def test_cluster_nodes_and_quotient_tables(reference, name):
    fn, args, ratio, metric, cs = CLUSTERINGS[name]
    g = _graph(fn, args)
    cl = coarsen.cluster_nodes(g, ratio, metric=metric, crit_scale=cs)
    assert cl.dtype == np.int32
    np.testing.assert_array_equal(cl, reference[name + "/clusters"])
    assert np.bincount(cl).max() <= ratio
    got = coarsen.quotient_tables(g, cl, metric=metric, crit_scale=cs)
    for k, v in zip(("src", "dst", "w_edge", "w_node"), got):
        want = reference[f"{name}/{k}"]
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("name", PIPELINES)
def test_multilevel_matches_reference(reference, name):
    args, (nx, ny), ratio, kw, rkw = PIPELINES[name]
    g = wl.arrow_lu_graph(*args, seed=3)
    ml = coarsen.multilevel_anneal(g, nx, ny, AnnealConfig(**kw), ratio=ratio,
                                   refine=_refine(rkw), device="cpu")
    np.testing.assert_array_equal(ml.node_pe, reference[name + "/node_pe"])
    np.testing.assert_array_equal(ml.clusters, reference[name + "/clusters"])
    assert ml.num_clusters == int(reference[name + "/num_clusters"])
    assert ml.cost == int(reference[name + "/cost"])
    assert ml.projected_cost == int(reference[name + "/projected_cost"])
    np.testing.assert_array_equal(ml.coarse.node_pe,
                                  reference[name + "/coarse_pe"])
    np.testing.assert_array_equal(ml.coarse.replica_costs,
                                  reference[name + "/coarse_costs"])
    assert ml.coarse.init_cost == int(reference[name + "/coarse_init"])
    if rkw is None:
        assert ml.refined is None and ml.cost == ml.projected_cost
    else:
        np.testing.assert_array_equal(ml.refined.replica_costs,
                                      reference[name + "/refined_costs"])
        assert ml.cost <= ml.projected_cost


def test_identity_clusters_are_the_plain_annealer():
    """With one node a cluster the quotient tables are the graph's own, so
    the coarse anneal IS the plain annealer, bit for bit."""
    args, (nx, ny), kw = IDENTITY
    g = wl.arrow_lu_graph(*args, seed=3)
    acfg = AnnealConfig(**kw)
    ml = coarsen.multilevel_anneal(g, nx, ny, acfg, refine=None,
                                   clusters=np.arange(g.num_nodes),
                                   device="cpu")
    plain = pa.anneal_placement(g, nx, ny, acfg, device="cpu")
    np.testing.assert_array_equal(ml.node_pe, plain.node_pe)
    np.testing.assert_array_equal(ml.coarse.replica_costs,
                                  plain.replica_costs)
    assert ml.cost == ml.projected_cost == plain.cost
    assert ml.num_clusters == g.num_nodes
    assert coarsen.cluster_nodes(g, 1).tolist() == list(range(g.num_nodes))


def test_default_refine_and_validation():
    acfg = AnnealConfig(replicas=8, rounds=24, steps=64, seed=3)
    r = coarsen.default_refine(acfg)
    assert (r.replicas, r.rounds, r.steps, r.seed) == (4, 6, 64, 3)
    assert coarsen.default_refine(AnnealConfig(replicas=2, rounds=3)).rounds == 1
    g = wl.arrow_lu_graph(2, 4, 3, seed=3)
    with pytest.raises(ValueError, match="ratio"):
        coarsen.cluster_nodes(g, 0)
    with pytest.raises(ValueError, match="refine"):
        coarsen.multilevel_anneal(g, 2, 2, refine="fast", device="cpu")
    with pytest.raises(ValueError, match="clusters must be"):
        coarsen.multilevel_anneal(g, 2, 2, clusters=np.zeros(3, np.int32),
                                  device="cpu")
    # a guide for another grid is refused at the coarse level already
    from repro_torch import surrogate
    from repro_torch.surrogate.delta import Guide

    guide = Guide(extractor=surrogate.build_features(g, 4, 1),
                  gamma_q=np.ones(29, np.int64))
    with pytest.raises(ValueError, match="guide was built"):
        coarsen.multilevel_anneal(g, 2, 2, guide=guide, device="cpu")


def test_fig1_full_small_calibration(reference, tmp_path):
    """The reference's small calibration size (``tests/test_coarsen.py``):
    the same graph bytes under the same cache file name, served from the
    cache the second time."""
    g1 = wl.fig1_full(target_nodes=FIG1_SMALL, seed=0,
                      cache_dir=str(tmp_path))
    g2 = wl.fig1_full(target_nodes=FIG1_SMALL, seed=0,
                      cache_dir=str(tmp_path))
    for f in ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
              "initial_values"):
        want = reference["fig1/" + f]
        assert getattr(g1, f).dtype == want.dtype, f
        np.testing.assert_array_equal(getattr(g1, f), want, err_msg=f)
        np.testing.assert_array_equal(getattr(g2, f), want, err_msg=f)
    assert sorted(os.listdir(tmp_path)) == list(reference["fig1/cache"])
    g3 = wl.fig1_full(target_nodes=FIG1_SMALL, seed=0, cache=False)
    np.testing.assert_array_equal(g3.fanout_dst, g1.fanout_dst)
