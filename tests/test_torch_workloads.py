"""The port's workload generators, graph cache and Table 1 cost model
against the reference's, on the CPU: every generator's graph byte-equal,
graphs saved by either package loading in the other, the five Table 1
values of ``BENCH_overlay.json`` exactly, and the ``eject`` rows (4x4 grid,
``ooo``, criticality layout, both eject policies) at their goldens.
"""
import json

import numpy as np
import pytest

from _torch_ref import ROOT, run_reference

import repro_torch
from repro_torch.core import partition as pt
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory

FIELDS = ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
          "initial_values")

#: name -> (generator, arguments, keyword arguments).
GENERATORS = {
    "sparse_lu": ("sparse_lu_graph", (24,), dict(density=0.25, seed=1)),
    "banded_lu": ("banded_lu_graph", (60, 12), dict(seed=3)),
    "banded_lu_sparse": ("banded_lu_graph", (30, 4),
                         dict(seed=2, inband_density=0.6)),
    "elimination_tree": ("elimination_tree_graph", (3,),
                         dict(chain_len=5, leaf_width=9, seed=4)),
    "reduction_tree": ("reduction_tree", (37,), dict(seed=5)),
    "chain": ("chain", (20,), dict(seed=6)),
    "random_dag": ("random_dag", (300,), dict(seed=7, input_frac=0.3)),
    "arrow_lu": ("arrow_lu_graph", (2, 8, 12), dict(seed=3)),
    "layered": ("layered_dag", (5, 8), dict(seed=3, skew=0.5)),
}
LU_TARGETS = (100, 5_000, 60_000, 470_000, 10_000_000)

#: The eject rows: name -> (generator, arguments, goldens as
#: {eject_policy: (cycles, deflections)}), from BENCH_overlay.json.
EJECT_ROWS = {
    "arrow_n9838": ("arrow_lu_graph", (2, 8, 12),
                    {"n_first": (3160, 25664), "priority": (3087, 26004)}),
    "banded_n16822": ("banded_lu_graph", (60, 12),
                      {"n_first": (4678, 31203), "priority": (4567, 33693)}),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cache = tmp_path_factory.mktemp("reference_cache")
    body = f"""
    from repro.core import workloads as wl
    from repro.core import partition as pt

    for name, (fn, args, kw) in {GENERATORS!r}.items():
        g = getattr(wl, fn)(*args, **kw)
        for f in {FIELDS!r}:
            res[f"{{name}}/{{f}}"] = np.asarray(getattr(g, f))
    for t in {LU_TARGETS!r}:
        res[f"lu_size/{{t}}"] = np.asarray(wl.lu_size_for_nodes(t))
    wl.save_graph(wl.chain(9, seed=2), {str(cache / "from_reference.npz")!r})
    res["table1/flag_overhead"] = np.asarray(pt.rdy_flag_overhead())
    for s in ("inorder", "ooo"):
        for k, v in pt.capacity_elements(256, s).items():
            res[f"table1/{{s}}/{{k}}"] = np.asarray(v)
    res["table1/fifo_worst"] = np.asarray(pt.fifo_worst_case_words(4096))
    """
    out = run_reference(tmp_path_factory, "workloads", body)
    out["cache"] = cache
    return out


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_byte_equal(reference, name):
    fn, args, kw = GENERATORS[name]
    g = getattr(wl, fn)(*args, **kw)
    for f in FIELDS:
        got, want = np.asarray(getattr(g, f)), reference[f"{name}/{f}"]
        assert got.dtype == want.dtype, (name, f)
        assert got.tobytes() == want.tobytes(), (name, f)


def test_lu_size_for_nodes(reference):
    for t in LU_TARGETS:
        assert list(wl.lu_size_for_nodes(t)) == reference[
            f"lu_size/{t}"].tolist()


def test_cache_round_trips_both_ways(reference, tmp_path_factory):
    cache = reference["cache"]
    mine = wl.load_graph(str(cache / "from_reference.npz"))
    want = wl.chain(9, seed=2)
    for f in FIELDS:
        assert np.array_equal(getattr(mine, f), getattr(want, f)), f
    # A graph the port saves loads in the reference.
    g = wl.random_dag(80, seed=11)
    path = cache / "from_port.npz"
    wl.save_graph(g, str(path))
    body = f"""
    from repro.core import workloads as wl
    g = wl.load_graph({str(path)!r})
    for f in {FIELDS!r}:
        res[f] = np.asarray(getattr(g, f))
    """
    back = run_reference(tmp_path_factory, "load_port_graph", body)
    for f in FIELDS:
        assert back[f].tobytes() == np.asarray(getattr(g, f)).tobytes(), f


def test_cached_graph_builds_once(tmp_path, monkeypatch):
    calls = []

    def build():
        calls.append(1)
        return wl.chain(5, seed=1)

    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path))
    assert wl.graph_cache_dir() == str(tmp_path)
    a = wl.cached_graph("chain5", build)
    b = wl.cached_graph("chain5", build)
    assert len(calls) == 1 and (tmp_path / "chain5.npz").exists()
    assert np.array_equal(a.fanout_dst, b.fanout_dst)
    monkeypatch.delenv("REPRO_GRAPH_CACHE")
    assert wl.graph_cache_dir().endswith("experiments/graph_cache")


def test_table1_matches_bench_and_reference(reference):
    bench = {r["name"]: r["value"] for r in json.loads(
        (ROOT / "BENCH_overlay.json").read_text())["table1"]}
    ino = pt.capacity_elements(256, "inorder")
    ooo = pt.capacity_elements(256, "ooo")
    got = {"table1_flag_overhead": pt.rdy_flag_overhead(),
           "table1_inorder_capacity_elems": ino["elements"],
           "table1_ooo_capacity_elems": ooo["elements"],
           "table1_capacity_ratio": ooo["elements"] / ino["elements"],
           "table1_fifo_words_freed": ino["fifo_words"]}
    assert got == bench
    assert got["table1_capacity_ratio"] == 3.7500083923595957
    assert pt.rdy_flag_overhead() == float(reference["table1/flag_overhead"])
    for s, mine in (("inorder", ino), ("ooo", ooo)):
        for k, v in mine.items():
            assert v == int(reference[f"table1/{s}/{k}"]), (s, k)
    assert pt.fifo_worst_case_words(4096) == int(reference["table1/fifo_worst"])
    with pytest.raises(ValueError):
        pt.capacity_elements(256, "scan")


@pytest.mark.parametrize("eject_policy", ["n_first", "priority"])
@pytest.mark.parametrize("row", EJECT_ROWS)
def test_eject_rows(row, eject_policy):
    fn, args, goldens = EJECT_ROWS[row]
    g = getattr(wl, fn)(*args, seed=3)
    gm = build_graph_memory(g, 4, 4, criticality_order=True)
    r = repro_torch.run(gm, OverlayConfig(scheduler="ooo",
                                          eject_policy=eject_policy,
                                          max_cycles=4_000_000),
                        device="cpu")
    assert r.done
    assert (r.cycles, r.deflections) == goldens[eject_policy]
