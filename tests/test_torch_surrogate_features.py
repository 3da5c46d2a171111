"""The port's surrogate features (``repro_torch.surrogate.features``, on the
CPU) against the reference's ``repro.surrogate.features``, bit for bit: the
extractor's tables, feature matrices of random placements on a square and a
non-square grid, the quotient extractor of a clustering (its tables, and
its features equal to the projected fine features), the defaults of
``features_from_tables``, and the errors. The BENCH surrogate rows'
training matrices (n3689 on 8x8, n10308 on 16x16) are held to the
reference's from ``tests/fixtures/surrogate_golden.npz``, with no
simulation.
"""
from pathlib import Path

import numpy as np
import pytest

from _torch_ref import run_reference

from repro_torch import place, surrogate
from repro_torch.core import workloads as wl
from repro_torch.surrogate import features as sf

GOLDEN = Path(__file__).parent / "fixtures" / "surrogate_golden.npz"
#: name -> (arrow_lu_graph args and seed, grid): the reference surrogate
#: tests' graph on 4x4 and its guided tests' graph on the non-square 4x5.
GRAPHS = {"s5_4x4": ((2, 6, 4, 5), (4, 4)), "s3_4x5": ((2, 6, 4, 3), (4, 5))}
#: The BENCH surrogate rows: name -> (arrow_lu_graph args, grid).
BENCH = {"n3689": ((2, 8, 6), (8, 8)), "n10308": ((4, 8, 8), (16, 16))}
TABLES = ("src", "dst", "w_edge", "w_node", "c_unit", "e_unit", "n_unit",
          "w_bucket")
N_RANDOM = 6


def _graph(name):
    args, grid = GRAPHS[name]
    return wl.arrow_lu_graph(*args[:3], seed=args[3]), grid


def _placements(n, grid, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, grid[0] * grid[1], size=(N_RANDOM, n)).astype(
        np.int32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    for k, name in enumerate(GRAPHS):
        g, grid = _graph(name)
        inputs[name] = _placements(g.num_nodes, grid, k)
    clusters = place.cluster_nodes(_graph("s3_4x5")[0], 8)
    body = f"""
    from repro import place, surrogate
    from repro.core import workloads as wl
    from repro.surrogate import features as sf

    graphs = {GRAPHS!r}
    inputs = {{k: np.array(v, np.int32) for k, v in {
        {k: v.tolist() for k, v in inputs.items()}!r}.items()}}
    for name, (args, grid) in graphs.items():
        g = wl.arrow_lu_graph(*args[:3], seed=args[3])
        ex = surrogate.build_features(g, *grid)
        for t in {TABLES!r}:
            res[f"{{name}}/{{t}}"] = getattr(ex, t)
        res[f"{{name}}/features"] = ex.features_batch(inputs[name])
    g = wl.arrow_lu_graph(2, 6, 4, seed=3)
    ex = surrogate.build_features(g, 4, 5)
    clusters = np.array({clusters.tolist()!r})
    cex = sf.coarsen_extractor(ex, clusters)
    for t in {TABLES!r}:
        res[f"coarse/{{t}}"] = getattr(cex, t)
    cpe = np.random.default_rng(5).integers(0, 20, size=(4, cex.num_items))
    res["coarse/features"] = cex.features_batch(cpe.astype(np.int32))
    res["coarse/cpe"] = cpe
    bare = sf.features_from_tables(4, 5, ex.src, ex.dst, ex.w_edge,
                                   ex.w_node)
    for t in {TABLES!r}:
        res[f"bare/{{t}}"] = getattr(bare, t)
    res["bare/features"] = bare.features_batch(inputs["s3_4x5"])
    """
    out = run_reference(tmp_path_factory, "surrogate_features", body)
    out["inputs"] = inputs
    return out


@pytest.mark.parametrize("name", list(GRAPHS))
def test_extractor_tables_equal_reference(reference, name):
    g, grid = _graph(name)
    ex = surrogate.build_features(g, *grid)
    for t in TABLES:
        np.testing.assert_array_equal(getattr(ex, t), reference[f"{name}/{t}"],
                                      err_msg=t)
        assert getattr(ex, t).dtype == reference[f"{name}/{t}"].dtype, t
    assert ex.num_features == sf.NUM_FEATURES == 29


@pytest.mark.parametrize("name", list(GRAPHS))
def test_features_equal_reference(reference, name):
    g, grid = _graph(name)
    ex = surrogate.build_features(g, *grid)
    got = ex.features_batch(reference["inputs"][name], device="cpu")
    want = reference[f"{name}/features"]
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_features_batch_matches_solo():
    g, grid = _graph("s5_4x4")
    ex = surrogate.build_features(g, *grid)
    cands = _placements(g.num_nodes, grid, 9)
    batch = ex.features_batch(cands, device="cpu")
    solo = np.stack([ex.features_batch(c, device="cpu")[0] for c in cands])
    np.testing.assert_array_equal(batch, solo)
    np.testing.assert_array_equal(batch, np.rint(batch))


def test_coarsened_equals_reference_and_projected_fine(reference):
    g, grid = _graph("s3_4x5")
    ex = surrogate.build_features(g, *grid)
    clusters = place.cluster_nodes(g, 8)
    cex = sf.coarsen_extractor(ex, clusters)
    for t in TABLES:
        np.testing.assert_array_equal(getattr(cex, t),
                                      reference[f"coarse/{t}"], err_msg=t)
    cpe = reference["coarse/cpe"].astype(np.int32)
    got = cex.features_batch(cpe, device="cpu")
    np.testing.assert_array_equal(got, reference["coarse/features"])
    np.testing.assert_array_equal(
        got, ex.features_batch(cpe[:, clusters], device="cpu"))


def test_features_from_tables_defaults(reference):
    g, grid = _graph("s3_4x5")
    ex = surrogate.build_features(g, *grid)
    bare = sf.features_from_tables(*grid, ex.src, ex.dst, ex.w_edge,
                                   ex.w_node)
    for t in TABLES:
        np.testing.assert_array_equal(getattr(bare, t),
                                      reference[f"bare/{t}"], err_msg=t)
    # No depth: every node's weight sits in bucket 0.
    np.testing.assert_array_equal(bare.w_bucket[:, 0], ex.w_node)
    assert not bare.w_bucket[:, 1:].any()
    np.testing.assert_array_equal(
        bare.features_batch(reference["inputs"]["s3_4x5"], device="cpu"),
        reference["bare/features"])


def test_feature_errors():
    g, grid = _graph("s5_4x4")
    ex = surrogate.build_features(g, *grid)
    with pytest.raises(ValueError, match="extractor was built for"):
        ex.features_batch(np.zeros((2, g.num_nodes + 1), np.int32),
                          device="cpu")
    with pytest.raises(ValueError, match="outside the"):
        ex.features_batch(np.full(g.num_nodes, 16, np.int32), device="cpu")
    with pytest.raises(ValueError, match="outside the"):
        ex.features_batch(np.full(g.num_nodes, -1, np.int32), device="cpu")
    with pytest.raises(ValueError, match="w_bucket must be"):
        sf.features_from_tables(*grid, ex.src, ex.dst, ex.w_edge, ex.w_node,
                                w_bucket=np.zeros((3, 8), np.int32))
    with pytest.raises(ValueError, match="clusters must be"):
        sf.coarsen_extractor(ex, np.zeros(3, np.int32))


@pytest.mark.parametrize("row", list(BENCH))
def test_bench_training_features_equal_fixture(row):
    """The BENCH surrogate rows' training matrices, bit for bit, from the
    fixture's placements (no simulation)."""
    args, grid = BENCH[row]
    g = wl.arrow_lu_graph(*args, seed=3)
    with np.load(GOLDEN) as z:
        placements = z[f"{row}/train/node_pe"].astype(np.int32)
        want = z[f"{row}/train/features"]
    got = surrogate.build_features(g, *grid).features_batch(placements,
                                                            device="cpu")
    np.testing.assert_array_equal(got, want)
