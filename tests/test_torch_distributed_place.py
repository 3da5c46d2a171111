"""Telemetry and placement over a mesh, on a 1x1 mesh in this process (a
gloo group of one rank), on the CPU: a traced run and a traced batch equal
the single-device runs, every trace leaf included (the reference's
``tests/test_telemetry.py:168``), and ``evaluate_placements(mesh=)``,
``simulate_placements(mesh=)`` and the surrogate's training set over the
mesh equal their single-device results (``tests/test_place.py:165``). The
single-device runs are held to the reference by the telemetry, placement and
surrogate tests. Traces over meshes of more ranks:
``tests/test_torch_distributed_multi.py``.
"""
import numpy as np
import pytest

import repro_torch
from repro_torch import place
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.surrogate.data import make_training_set
from repro_torch.telemetry import TelemetrySpec

from _torch_ref import assert_same_result, one_rank_mesh

ENGINES = ("tensor", "select", "megakernel")
SPEC = dict(buckets=16, bucket_cycles=8)
#: ``tests/test_place.py``'s graph (the matrix graph).
G = wl.arrow_lu_graph(3, 6, 4, seed=5)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 1x1 CPU mesh over a gloo group of this one process."""
    with one_rank_mesh(tmp_path_factory.mktemp("mesh")) as m:
        yield m


@pytest.mark.parametrize("engine", ENGINES)
def test_traces_match_solo(mesh, engine):
    """``tests/test_telemetry.py:168``: a traced run and a traced batch on a
    1x1 mesh equal the single-device runs, every trace leaf included (the
    batch's rows share one packed memory, so each solo run does too)."""
    spec = TelemetrySpec(**SPEC)
    gm = build_graph_memory(G, 4, 4, criticality_order=True)
    cfg = OverlayConfig(telemetry=spec, engine=engine)
    r = repro_torch.run(gm, cfg, mesh=mesh, device="cpu")
    assert r.done
    assert_same_result(r, repro_torch.run(gm, cfg, device="cpu"), engine)
    cfgs = [OverlayConfig(scheduler=s, telemetry=spec, engine=engine)
            for s in ("ooo", "inorder")]
    rs = repro_torch.run(gm, mesh=mesh, device="cpu", batch=cfgs)
    assert_same_result(rs[1], repro_torch.run(gm, cfgs[1], device="cpu"),
                       (engine, "inorder"))
    assert_same_result(rs[0], r, (engine, "ooo"))


def test_evaluate_and_simulate_placements(mesh):
    """``tests/test_place.py:165``: ``evaluate_placements(mesh=)`` equals
    the single-device evaluation (a mixed-layout sweep is refused first),
    and so do ``simulate_placements(mesh=)`` and the surrogate's sampled
    training set over the mesh."""
    g = G
    cfgs = [OverlayConfig(max_cycles=500_000),
            OverlayConfig(select_latency=2, max_cycles=500_000)]
    pls = {"identity": None, "clustered": "clustered"}
    with pytest.raises(ValueError, match="wants_criticality_order"):
        place.evaluate_placements(
            g, 4, 4, pls, mesh=mesh, device="cpu",
            cfgs=cfgs + [OverlayConfig(scheduler="inorder")])
    solo = place.evaluate_placements(g, 4, 4, pls, cfgs=cfgs, device="cpu")
    shard = place.evaluate_placements(g, 4, 4, pls, cfgs=cfgs, mesh=mesh,
                                      device="cpu")
    for name in pls:
        for i, (a, b) in enumerate(zip(shard[name], solo[name])):
            assert_same_result(a, b, (name, i))
    node_pes = [place.resolve(g, 4, 4, p) for p in ("round_robin", "random")]
    for a, b in zip(
            place.simulate_placements(g, 4, 4, node_pes, mesh=mesh,
                                      device="cpu"),
            place.simulate_placements(g, 4, 4, node_pes, device="cpu")):
        assert_same_result(a, b)
    got = make_training_set(g, 4, 4, n=3, seed=1, mesh=mesh, device="cpu")
    want = make_training_set(g, 4, 4, n=3, seed=1, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


