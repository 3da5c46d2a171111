"""The port's host-side IR, state hand-over and front door against the
reference: GraphMemory arrays byte-equal, generator graphs byte-equal, a
reference state carried over mid-run reaching the reference's later state
leaf for leaf, the Fig. 1 graph at full 16x16 width on the CPU, and the
device and config rules of ``repro_torch.run``.

The per-policy engine matrix lives in ``test_torch_matrix_*.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from _torch_ref import (assert_same_result, assert_tree_equal, one_rank_mesh,
                        run_reference, unflatten)
from repro_torch.convert import (graph_memory_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import overlay
from repro_torch.core import workloads as wl
from repro_torch.core.graph import reference_evaluate
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import GraphMemory, build_graph_memory
from repro_torch.place import PlacementSpec

GRAPHS = {"layered": lambda: wl.layered_dag(4, 6, seed=3),
          "arrow": lambda: wl.arrow_lu_graph(3, 6, 4, seed=5)}
GRAPH_FIELDS = ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
                "initial_values")
CARRY = (17, 200)   # hand over at cycle 17, compare at cycle 200


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import dataclasses
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig, _run_jit, device_graph
    from repro.core.partition import build_graph_memory

    graphs = dict(layered=wl.layered_dag(4, 6, seed=3),
                  arrow=wl.arrow_lu_graph(3, 6, 4, seed=5))
    for name, g in graphs.items():
        for f in {GRAPH_FIELDS!r}:
            res[f"graph/{{name}}/{{f}}"] = getattr(g, f)
        for crit in (True, False):
            gm = build_graph_memory(g, 2, 2, criticality_order=crit)
            for f in dataclasses.fields(gm):
                res[f"gm/{{name}}/{{crit}}/{{f.name}}"] = np.asarray(
                    getattr(gm, f.name))
    for pol in ("ooo", "inorder"):
        gm = build_graph_memory(graphs["arrow"], 2, 2,
                                criticality_order=pol == "ooo")
        g = dict(device_graph(gm))
        for n in {CARRY!r}:
            cfg = OverlayConfig(scheduler=pol, check_every=1, max_cycles=n)
            res.update(flatten(_run_jit(g, cfg, gm.nx, gm.ny),
                               f"state/{{pol}}/{{n}}"))
    """
    return run_reference(tmp_path_factory, "overlay", body)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_workload_graphs_byte_equal(reference, name):
    g = GRAPHS[name]()
    for f in GRAPH_FIELDS:
        want = reference[f"graph/{name}/{f}"]
        got = getattr(g, f)
        assert got.dtype == want.dtype, f
        assert got.tobytes() == want.tobytes(), f


@pytest.mark.parametrize("crit", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_memory_byte_equal(reference, name, crit):
    gm = build_graph_memory(GRAPHS[name](), 2, 2, criticality_order=crit)
    fields = {f.name: reference[f"gm/{name}/{crit}/{f.name}"]
              for f in dataclasses.fields(GraphMemory)}
    for f, want in fields.items():
        got = np.asarray(getattr(gm, f))
        assert got.dtype == want.dtype, f
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), f
    # The converter rebuilds the same memory from the reference's arrays.
    carried = graph_memory_from_numpy(fields)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(carried, f)),
                                      np.asarray(getattr(gm, f)), err_msg=f)


@pytest.mark.parametrize("engine", ["tensor", "select"])
@pytest.mark.parametrize("policy", ["ooo", "inorder"])
def test_state_carried_across_matches_reference(reference, policy, engine):
    start, end = CARRY
    gm = build_graph_memory(GRAPHS["arrow"](), 2, 2,
                            criticality_order=policy == "ooo")
    g = overlay.device_graph(gm, device="cpu")
    state = state_from_numpy(unflatten(reference, f"state/{policy}/{start}"),
                             device="cpu")
    assert int(state["cycle"]) == start
    cfg = OverlayConfig(scheduler=policy, check_every=1, max_cycles=end,
                        engine=engine)
    final = state_to_numpy(overlay.run_state(g, cfg, state))
    assert_tree_equal(final, unflatten(reference, f"state/{policy}/{end}"))


def test_initial_state_matches_reference_layout(reference):
    """init_state has the reference's keys and dtypes (values at cycle 0)."""
    gm = build_graph_memory(GRAPHS["arrow"](), 2, 2)
    st = state_to_numpy(overlay.init_state(
        overlay.device_graph(gm, device="cpu"), OverlayConfig()))
    want = unflatten(reference, f"state/ooo/{CARRY[0]}")

    def keys(t):
        return {k: keys(v) if isinstance(v, dict) else v.dtype
                for k, v in t.items()}

    assert keys(st) == keys(want)


def test_fig1_full_width_on_cpu():
    """arrow_lu_graph(4, 10, 8, seed=3) on the 16x16 grid: the reference's
    Fig. 1 cycle counts, each policy on its own memory layout."""
    g = wl.arrow_lu_graph(4, 10, 8, seed=3)
    assert g.num_nodes == 15_072
    ref = reference_evaluate(g)
    for policy, golden in (("ooo", 2125), ("inorder", 2369)):
        r = repro_torch.run(g, OverlayConfig(scheduler=policy), nx=16, ny=16,
                            device="cpu")
        assert r.done and r.cycles == golden, (policy, r.cycles)
        np.testing.assert_allclose(r.values, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["run", "device_graph", "state_from_numpy"])
def test_run_without_device_needs_cuda(monkeypatch, entry):
    """``device=None`` means the card, on the front door and on the hand-over
    path (``run_state(device_graph(gm), cfg, state_from_numpy(tree))``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = wl.layered_dag(3, 4, seed=1)
    make = {"run": lambda: repro_torch.run(g, nx=2, ny=2),
            "device_graph": lambda: overlay.device_graph(
                build_graph_memory(g, 2, 2)),
            "state_from_numpy": lambda: state_from_numpy(
                {"cycle": np.int32(0), "sched": {"ptr": np.zeros(2, np.int32)}})}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make[entry]()


def test_parts_not_ported_yet_raise(tmp_path):
    g = wl.layered_dag(3, 4, seed=1)
    # Placement is ported, the surrogate-guided search too: a guided spec
    # rides in a config as any other spec.
    for strategy in ("anneal", "multilevel"):
        spec = PlacementSpec(strategy=strategy, guide="surrogate")
        assert OverlayConfig(placement=spec).placement == spec
    # Telemetry is ported: what is not a TelemetrySpec is refused, as the
    # reference refuses it.
    with pytest.raises(TypeError, match="TelemetrySpec"):
        OverlayConfig(telemetry=object())
    with pytest.raises(ValueError, match="engine"):
        OverlayConfig(engine="xla")
    # The sharded engines are ported: a raw graph on a 1x1 mesh runs as on
    # one device, leaf for leaf (meshes of more ranks:
    # tests/test_torch_distributed*.py).
    with one_rank_mesh(tmp_path) as mesh:
        got = repro_torch.run(g, mesh=mesh, nx=2, ny=2, device="cpu")
    want = repro_torch.run(g, nx=2, ny=2, device="cpu")
    assert got.done
    assert_same_result(got, want)


def test_reference_spellings_run_as_the_defaults():
    """``placement="identity"`` is the identity placement (``None``) and
    ``engine="jnp"`` the ``"tensor"`` engine, as the reference names them:
    the same results, leaf for leaf, on the matrix graph."""
    assert OverlayConfig(placement="identity") == OverlayConfig()
    assert OverlayConfig(engine="jnp") == OverlayConfig(engine="tensor")
    g = GRAPHS["arrow"]()
    want = repro_torch.run(g, OverlayConfig(engine="tensor"), nx=4, ny=4,
                           device="cpu")
    got = repro_torch.run(g, OverlayConfig(placement="identity",
                                           engine="jnp"), nx=4, ny=4,
                          device="cpu")
    assert got.done
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), f.name
        else:
            assert a == b, f.name


def test_values_match_reference_evaluate_on_small_graphs():
    for name, make in GRAPHS.items():
        g = make()
        for policy in ("ooo", "inorder", "lru_flat"):
            r = repro_torch.run(g, OverlayConfig(scheduler=policy), nx=2, ny=2,
                                device="cpu")
            assert r.done and r.delivered == g.num_edges, (name, policy)
            np.testing.assert_allclose(r.values, reference_evaluate(g),
                                       rtol=1e-5, atol=1e-5)
