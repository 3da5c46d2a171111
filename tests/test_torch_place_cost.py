"""The port's placement cost model (``repro_torch.place.cost``) and the
annealer's move delta against the reference's, on the CPU, exactly: the
scoring tables for every criticality metric, per-placement traffic, loads,
pressure and cost, ``batch_cost`` over a stack, the torus hop count, and the
O(degree) ``_move_delta`` — equal to the reference's and to a full re-cost
of the moved placement.
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_reference

from repro_torch.core import workloads as wl
from repro_torch.place import anneal as pa
from repro_torch.place import cost

#: name -> (generator, args, grid, metric, crit_scale, pressure_weight)
CASES = {
    "arrow_8x8": ("arrow_lu_graph", (2, 8, 6), (8, 8), "height", 3, 1),
    "arrow_4x4_slack": ("arrow_lu_graph", (2, 4, 3), (4, 4), "neg_slack", 5, 2),
    "layered_2x3_fanout": ("layered_dag", (5, 8), (2, 3), "fanout_height",
                           1, 3),
    "banded_16x16": ("banded_lu_graph", (30, 4), (16, 16), "height", 3, 1),
}
B = 6          # random placements scored per case
MOVES = 40     # single-node moves per case


def _graph(case):
    fn, args, *_ = CASES[case]
    return getattr(wl, fn)(*args, seed=3)


def _placements(case, n, num_pes):
    rng = np.random.default_rng(sum(map(ord, case)))
    pes = rng.integers(0, num_pes, size=(B, n)).astype(np.int32)
    pes[0] = np.arange(n) % num_pes
    return pes


def _moves(case, n, num_pes):
    rng = np.random.default_rng(7 + len(case))
    return (rng.integers(0, n, size=MOVES).astype(np.int32),
            rng.integers(0, num_pes, size=MOVES).astype(np.int32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import jax.numpy as jnp
    from repro.core import workloads as wl
    from repro.place import anneal as pa
    from repro.place import cost

    cases = {CASES!r}
    B, MOVES = {B}, {MOVES}
    for case, (fn, args, (nx, ny), metric, cs, pw) in cases.items():
        g = getattr(wl, fn)(*args, seed=3)
        n, P = g.num_nodes, nx * ny
        src, dst, w_edge, w_node = cost.edge_tables(g, metric=metric,
                                                    crit_scale=cs)
        for k, v in dict(src=src, dst=dst, w_edge=w_edge,
                         w_node=w_node).items():
            res[f"{{case}}/{{k}}"] = v
        m = cost.build_cost_model(g, nx, ny, metric=metric, crit_scale=cs,
                                  pressure_weight=pw)
        rng = np.random.default_rng(sum(map(ord, case)))
        pes = rng.integers(0, P, size=(B, n)).astype(np.int32)
        pes[0] = np.arange(n) % P
        with jax.enable_x64(True):
            res[f"{{case}}/batch_cost"] = np.asarray(m.batch_cost(pes))
            for b in range(B):
                for f in ("traffic", "loads", "pressure", "cost"):
                    res[f"{{case}}/{{b}}/{{f}}"] = np.asarray(
                        getattr(m, f)(pes[b]))
            res[f"{{case}}/hops"] = np.asarray(cost.torus_hops(
                jnp.asarray(pes[1]), jnp.asarray(pes[2]), nx, ny))
            nbr, w_inc, is_out = pa.incidence_from_edges(src, dst, w_edge, n)
            rng = np.random.default_rng(7 + len(case))
            items = rng.integers(0, n, size=MOVES).astype(np.int32)
            targets = rng.integers(0, P, size=MOVES).astype(np.int32)
            pe = jnp.asarray(pes[1])
            load = pa._pe_loads(pe, jnp.asarray(w_node), P)
            deltas = []
            for i, q in zip(items, targets):
                d, _, _ = pa._move_delta(pe, load, int(i), int(q), nbr,
                                         jnp.asarray(w_inc),
                                         jnp.asarray(is_out),
                                         jnp.asarray(w_node), jnp.int64(pw),
                                         nx, ny)
                deltas.append(int(d))
            res[f"{{case}}/deltas"] = np.asarray(deltas, np.int64)
            res[f"{{case}}/placement_cost"] = np.asarray(pa._placement_cost(
                pe, jnp.asarray(nbr), jnp.asarray(w_inc), jnp.asarray(is_out),
                jnp.asarray(w_node), jnp.int64(pw), nx, ny))
    """
    return run_reference(tmp_path_factory, "place_cost", body)


@pytest.mark.parametrize("case", CASES)
def test_edge_tables(reference, case):
    _, _, _, metric, cs, _ = CASES[case]
    got = cost.edge_tables(_graph(case), metric=metric, crit_scale=cs)
    for k, v in zip(("src", "dst", "w_edge", "w_node"), got):
        want = reference[f"{case}/{k}"]
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_cost_model_terms(reference, case):
    _, _, (nx, ny), metric, cs, pw = CASES[case]
    g = _graph(case)
    m = cost.build_cost_model(g, nx, ny, metric=metric, crit_scale=cs,
                              pressure_weight=pw, device="cpu")
    pes = _placements(case, g.num_nodes, nx * ny)
    for b in range(B):
        for f in ("traffic", "loads", "pressure", "cost"):
            got = getattr(m, f)(pes[b])
            assert got.dtype == torch.int64, f
            np.testing.assert_array_equal(
                got.numpy(), reference[f"{case}/{b}/{f}"], err_msg=f"{b} {f}")
    got = m.batch_cost(pes)
    np.testing.assert_array_equal(got.numpy(), reference[f"{case}/batch_cost"])
    # a torch tensor scores as its numpy twin
    assert int(m.cost(torch.from_numpy(pes[2]))) == int(m.cost(pes[2]))


@pytest.mark.parametrize("case", CASES)
def test_torus_hops(reference, case):
    _, _, (nx, ny), *_ = CASES[case]
    g = _graph(case)
    pes = torch.from_numpy(_placements(case, g.num_nodes, nx * ny))
    got = cost.torus_hops(pes[1], pes[2], nx, ny)
    np.testing.assert_array_equal(got.numpy(), reference[f"{case}/hops"])
    assert int(got.min()) >= 0 and int(got.max()) <= nx + ny - 2


@pytest.mark.parametrize("case", CASES)
def test_move_delta_matches_reference_and_full_recost(reference, case):
    """Each move's O(degree) delta equals the reference's and the change of
    the full cost of the moved placement."""
    _, _, (nx, ny), metric, cs, pw = CASES[case]
    g = _graph(case)
    n, P = g.num_nodes, nx * ny
    src, dst, w_edge, w_node = cost.edge_tables(g, metric=metric,
                                                crit_scale=cs)
    nbr, w_inc, is_out = (torch.from_numpy(a) for a in
                          pa.incidence_from_edges(src, dst, w_edge, n))
    w_node_t = torch.from_numpy(w_node)
    pe = torch.from_numpy(_placements(case, n, P)[1])
    full = pa._placement_cost(pe, nbr, w_inc, is_out, w_node_t, pw, nx, ny)
    assert int(full) == int(reference[f"{case}/placement_cost"])
    m = cost.build_cost_model(g, nx, ny, metric=metric, crit_scale=cs,
                              pressure_weight=pw, device="cpu")
    assert int(full) == int(m.cost(pe))
    load = pa._pe_loads(pe, w_node_t, P)
    items, targets = _moves(case, n, P)
    # every move at once, as a batch of replicas
    deltas, p, wn = pa._move_delta(
        pe.expand(MOVES, n), load.expand(MOVES, P), torch.from_numpy(items),
        torch.from_numpy(targets), nbr, w_inc, is_out, w_node_t, pw, nx, ny)
    np.testing.assert_array_equal(deltas.numpy(), reference[f"{case}/deltas"])
    for k, (i, q) in enumerate(zip(items, targets)):
        assert int(p[k]) == int(pe[i]) and int(wn[k]) == int(w_node[i])
        if int(q) == int(pe[i]):
            # a move to its own PE prices the load it would add; the
            # annealer never accepts it (p != q), as the reference's
            assert int(deltas[k]) == 2 * pw * int(w_node[i]) ** 2
            continue
        moved = pe.clone()
        moved[i] = int(q)
        assert int(deltas[k]) == int(m.cost(moved)) - int(full), (i, q)


def test_integer_weights_and_int64_sums():
    """The weight ramp floors, starts at 1 and never exceeds
    1 + crit_scale; the squared loads of a large graph pass 2**31 without
    wrapping."""
    w = cost.integer_weights(np.array([-4, -2, 0, 5, 5]), 3)
    np.testing.assert_array_equal(w, [1, 1, 2, 4, 4])
    assert w.dtype == np.int32
    assert cost.integer_weights(np.zeros(0, np.int64), 3).shape == (0,)
    g = wl.arrow_lu_graph(32, 10, 8, seed=3)
    m = cost.build_cost_model(g, 1, 1, device="cpu")   # every node on one PE
    c = int(m.cost(np.zeros(g.num_nodes, np.int32)))
    assert c == int(m.w_node.to(torch.int64).sum()) ** 2 > 2**31
