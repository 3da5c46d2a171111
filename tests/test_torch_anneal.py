"""The port's annealer (``repro_torch.place.anneal``, its plain version on
the CPU) against the reference's ``_anneal_jit`` on the non-partitionable
Threefry layout, bit for bit at small budgets: best placements, best costs
per replica and the init cost, for 1, 2, 3 and 8 replicas on 2x2 to 8x8
grids, one to four rounds (both exchange parities) of 8 to 64 steps, random
and warm starts; the batched ``anneal_tables_many`` / ``anneal_placements``
(each element equal to its solo run); and the pieces: incidence tables,
thresholds and the exchange.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import run_reference

from repro_torch.core import workloads as wl
from repro_torch.place import anneal as pa
from repro_torch.place import cost
from repro_torch.place.spec import AnnealConfig

#: name -> (arrow_lu_graph args, grid, AnnealConfig keywords, init)
CASES = {
    "r1_2x2": ((2, 4, 3), (2, 2), dict(replicas=1, rounds=2, steps=16,
                                       seed=0), None),
    "r2_4x4": ((2, 4, 3), (4, 4), dict(replicas=2, rounds=3, steps=32,
                                       seed=5), None),
    "r8_4x4": ((2, 4, 3), (4, 4), dict(replicas=8, rounds=4, steps=64,
                                       seed=1), None),
    "r8_8x8_hot": ((2, 4, 3), (8, 8), dict(replicas=8, rounds=3, steps=8,
                                           seed=2, t_max=500.0), None),
    "r3_4x2_greedy": ((2, 5, 3), (4, 2), dict(replicas=3, rounds=2, steps=24,
                                              seed=9, t_max=0.0), None),
    "r8_8x8_n3689": ((2, 8, 6), (8, 8), dict(replicas=8, rounds=2, steps=32,
                                             seed=0), None),
    "r4_8x8_warm": ((2, 8, 6), (8, 8), dict(replicas=4, rounds=2, steps=16,
                                            seed=3, pressure_weight=2,
                                            crit_scale=5), "round_robin"),
}
#: anneal_tables_many: one item set, ladders differing in seed and t_max.
MANY = ((2, 4, 3), (4, 4), [dict(replicas=8, rounds=2, steps=16, seed=s,
                                  t_max=t) for s, t in ((0, 64.0), (1, 8.0),
                                                        (4, 300.0))])
THRESHOLD_CONFIGS = [dict(replicas=r, t_max=t) for r in (1, 2, 3, 8, 16)
                     for t in (0.0, 1.5, 64.0, 1000.0)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import jax.numpy as jnp
    from repro import place
    from repro.core import workloads as wl
    from repro.place import anneal as pa
    from repro.place import cost

    for name, (args, (nx, ny), kw, init) in {CASES!r}.items():
        g = wl.arrow_lu_graph(*args, seed=3)
        if init is not None:
            init = place.resolve(g, nx, ny, init)
        r = place.anneal_placement(g, nx, ny, place.AnnealConfig(**kw),
                                   init=init)
        res[name + "/node_pe"] = r.node_pe
        res[name + "/cost"] = np.int64(r.cost)
        res[name + "/init_cost"] = np.int64(r.init_cost)
        res[name + "/replica_costs"] = r.replica_costs
    args, (nx, ny), kws = {MANY!r}
    g = wl.arrow_lu_graph(*args, seed=3)
    for q, r in enumerate(place.anneal_placements(
            g, nx, ny, [place.AnnealConfig(**kw) for kw in kws])):
        res[f"many/{{q}}/node_pe"] = r.node_pe
        res[f"many/{{q}}/cost"] = np.int64(r.cost)
        res[f"many/{{q}}/init_cost"] = np.int64(r.init_cost)
        res[f"many/{{q}}/replica_costs"] = r.replica_costs
    src, dst, w_edge, _ = cost.edge_tables(g)
    for k, v in zip(("nbr", "w_inc", "is_out"),
                    pa.incidence_from_edges(src, dst, w_edge, g.num_nodes)):
        res["incidence/" + k] = v
    res["incidence/payload"] = pa.incidence_payload(
        src, dst, np.arange(len(src), dtype=np.int64) * 3, g.num_nodes)
    for i, kw in enumerate({THRESHOLD_CONFIGS!r}):
        res[f"thresholds/{{i}}"] = pa._thresholds(place.AnnealConfig(**kw))
    rng = np.random.default_rng(0)
    for R in (1, 2, 3, 5, 8):
        costs = rng.integers(0, 5, size=R)
        res[f"take/{{R}}/costs"] = costs
        for parity in (0, 1):
            with jax.enable_x64(True):
                res[f"take/{{R}}/{{parity}}"] = np.asarray(
                    pa._pt_take(jnp.asarray(costs), parity))
    """
    return run_reference(tmp_path_factory, "anneal", body, legacy_prng=True)


def _check(r, reference, prefix):
    np.testing.assert_array_equal(r.node_pe, reference[prefix + "/node_pe"])
    assert r.node_pe.dtype == np.int32
    assert r.cost == int(reference[prefix + "/cost"])
    assert r.init_cost == int(reference[prefix + "/init_cost"])
    np.testing.assert_array_equal(r.replica_costs,
                                  reference[prefix + "/replica_costs"])
    assert r.replica_costs.dtype == np.int64


@pytest.mark.parametrize("case", CASES)
def test_anneal_placement_matches_reference(reference, case):
    from repro_torch.core import partition

    args, (nx, ny), kw, init = CASES[case]
    g = wl.arrow_lu_graph(*args, seed=3)
    if init is not None:
        init = partition.place_nodes(g, nx * ny, init)
    r = pa.anneal_placement(g, nx, ny, AnnealConfig(**kw), init=init,
                            device="cpu")
    _check(r, reference, case)
    # the best placement's cost is what the model says it is
    acfg = AnnealConfig(**kw)
    m = cost.build_cost_model(g, nx, ny, crit_scale=acfg.crit_scale,
                              pressure_weight=acfg.pressure_weight,
                              device="cpu")
    assert int(m.cost(r.node_pe)) == r.cost <= r.init_cost


def test_anneal_many_matches_reference_and_solo(reference):
    args, (nx, ny), kws = MANY
    g = wl.arrow_lu_graph(*args, seed=3)
    acfgs = [AnnealConfig(**kw) for kw in kws]
    many = pa.anneal_placements(g, nx, ny, acfgs, device="cpu")
    assert len(many) == len(acfgs)
    for q, (r, acfg) in enumerate(zip(many, acfgs)):
        _check(r, reference, f"many/{q}")
        solo = pa.anneal_placement(g, nx, ny, acfg, device="cpu")
        np.testing.assert_array_equal(r.node_pe, solo.node_pe)
        np.testing.assert_array_equal(r.replica_costs, solo.replica_costs)
    src, dst, w_edge, w_node = cost.edge_tables(g)
    tables = pa.anneal_tables_many(g.num_nodes, nx, ny, src, dst, w_edge,
                                   w_node, acfgs, device="cpu")
    for q, r in enumerate(tables):
        _check(r, reference, f"many/{q}")


def test_incidence_tables(reference):
    args, _, _ = MANY
    g = wl.arrow_lu_graph(*args, seed=3)
    src, dst, w_edge, _ = cost.edge_tables(g)
    got = pa.incidence_from_edges(src, dst, w_edge, g.num_nodes)
    for k, v in zip(("nbr", "w_inc", "is_out"), got):
        want = reference["incidence/" + k]
        assert v.dtype == want.dtype
        np.testing.assert_array_equal(v, want, err_msg=k)
    for a, b in zip(pa.incidence_table(g, w_edge), got):
        np.testing.assert_array_equal(a, b)
    payload = pa.incidence_payload(src, dst, np.arange(len(src),
                                                       dtype=np.int64) * 3,
                                   g.num_nodes)
    np.testing.assert_array_equal(payload, reference["incidence/payload"])


def test_thresholds_and_exchange(reference):
    for i, kw in enumerate(THRESHOLD_CONFIGS):
        got = pa._thresholds(AnnealConfig(**kw))
        np.testing.assert_array_equal(got, reference[f"thresholds/{i}"])
        assert got.dtype == np.int64
    for R in (1, 2, 3, 5, 8):
        costs = torch.from_numpy(reference[f"take/{R}/costs"])
        for parity in (0, 1):
            take = pa._pt_take(costs, parity)
            np.testing.assert_array_equal(take.numpy(),
                                          reference[f"take/{R}/{parity}"])
            # an exchange is a permutation that is its own inverse
            assert sorted(take.tolist()) == list(range(R))
            assert take[take].tolist() == list(range(R))
            # batched over ladders, row by row
            both = pa._pt_take(torch.stack([costs, costs.flip(0)]), parity)
            assert both[0].tolist() == take.tolist()
            assert both[1].tolist() == pa._pt_take(costs.flip(0),
                                                   parity).tolist()


def test_plain_annealer_shapes_and_round_proposals():
    """``anneal_plain`` returns every rung's best; the proposals of a round
    drawn as one batch equal a step-by-step draw of the chain."""
    from repro_torch.core import prng

    keys = prng.split(prng.key(11), 3)
    i, q, after = pa.round_proposals(keys, 5, 100, 16)
    assert i.shape == q.shape == (5, 3) and i.dtype == torch.int32
    k = keys
    for t in range(5):
        new = prng.split(k, 2)
        step, k = new[:, 0], new[:, 1]
        halves = prng.split(step, 2)
        assert prng.randint(halves[:, 0], (), 0, 100).tolist() == i[t].tolist()
        assert prng.randint(halves[:, 1], (), 0, 16).tolist() == q[t].tolist()
    assert after.tolist() == k.tolist()
    args, (nx, ny), kws = MANY
    g = wl.arrow_lu_graph(*args, seed=3)
    src, dst, w_edge, w_node = cost.edge_tables(g)
    tabs = [torch.from_numpy(a) for a in
            pa.incidence_from_edges(src, dst, w_edge, g.num_nodes)]
    init = torch.zeros(2, g.num_nodes, dtype=torch.int32)
    best_pe, best_cost, init_cost = pa.anneal_plain(
        init, *tabs, torch.from_numpy(w_node),
        torch.zeros(2, 4, dtype=torch.int64),
        torch.stack([prng.key(0), prng.key(1)]), nx=nx, ny=ny, rounds=1,
        steps=4, pressure_weight=1)
    assert best_pe.shape == (2, 4, g.num_nodes) and best_pe.dtype == torch.int32
    assert best_cost.shape == (2, 4) and best_cost.dtype == torch.int64
    assert init_cost.shape == (2,) and bool((best_cost <= init_cost[:, None]).all())
    # the start rows are new tensors, at one replica too: the kernel updates
    # them in place and must leave the caller's init alone
    for R in (1, 3):
        pe, load, cost0 = pa.ladder_start(init, *tabs,
                                          torch.from_numpy(w_node), R, nx,
                                          ny, 1)
        assert pe.shape == (2, R, g.num_nodes) and pe.is_contiguous()
        assert load.is_contiguous() and cost0.is_contiguous()
        pe.fill_(1)
        assert int(init.abs().sum()) == 0


def test_anneal_validation():
    g = wl.arrow_lu_graph(2, 4, 3, seed=3)
    acfg = AnnealConfig(replicas=2, rounds=1, steps=2)
    # a guide for another grid, or a gate period below 1, is refused as the
    # reference refuses it
    from repro_torch import surrogate
    from repro_torch.surrogate.delta import Guide

    guide = Guide(extractor=surrogate.build_features(g, 2, 2),
                  gamma_q=np.ones(29, np.int64))
    with pytest.raises(ValueError, match="guide was built"):
        pa.anneal_placement(g, 4, 1, acfg, guide=guide, device="cpu")
    with pytest.raises(ValueError, match="guide_every"):
        pa.anneal_placement(g, 2, 2, acfg, guide=guide, guide_every=0,
                            device="cpu")
    with pytest.raises(ValueError, match="init must be"):
        pa.anneal_placement(g, 2, 2, acfg, init=np.zeros(3, np.int32),
                            device="cpu")
    with pytest.raises(ValueError, match="outside the grid"):
        pa.anneal_placement(g, 2, 2, acfg,
                            init=np.full(g.num_nodes, 4, np.int32),
                            device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        pa.anneal_placements(g, 2, 2, [acfg, dataclasses.replace(
            acfg, steps=3)], device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        pa.anneal_placements(g, 2, 2, [acfg, dataclasses.replace(
            acfg, crit_scale=1)], device="cpu")
    assert pa.anneal_placements(g, 2, 2, [], device="cpu") == []
    with pytest.raises(ValueError):
        AnnealConfig(replicas=0)
    with pytest.raises(ValueError):
        AnnealConfig(t_max=-1.0)
