"""The sharded engines on a 1x1 mesh, in this process (a gloo group of one
rank), on the CPU: ``repro_torch.run(..., mesh=)`` solo and batched under
every policy and engine, each equal bit for bit to the port's single-device
run and to the reference's (counterparts of the reference's
``tests/test_chunked.py:127,146``, ``tests/test_schedulers.py:122`` and
``tests/test_megakernel.py:78``, which hold its 1x1 mesh runs equal to its
single-device runs; the reference's runs here are single-device ones, a
third of the cost of its mesh path on the CPU), the deprecated entry points
and the front door's validation. On a 1x1 mesh the reduce is the identity
and no collective is launched. Telemetry and placement over a mesh:
``tests/test_torch_distributed_place.py``; meshes of more ranks:
``tests/test_torch_distributed_multi.py``.
"""
import dataclasses

import numpy as np
import pytest
from torch.distributed.device_mesh import init_device_mesh

import repro_torch
from repro_torch.core import distributed
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.telemetry import TelemetrySpec

from _torch_ref import (assert_matches, assert_same_result, one_rank_mesh,
                        run_reference)

POLICIES = ("ooo", "inorder", "lru_flat", "scan")
ENGINES = ("tensor", "select", "megakernel")
#: The reference's batch of ``tests/test_chunked.py:146``: every policy, and
#: ``scan`` again at a budget of 60 (it freezes mid-run).
ARROW_BATCH = [*(dict(scheduler=p, max_cycles=500_000) for p in POLICIES),
               dict(scheduler="scan", max_cycles=60)]
LAYERED_BATCH = [dict(scheduler=p, max_cycles=100_000) for p in ("ooo", "scan")]


def _arrow():
    """``tests/test_chunked.py:127``'s graph and grid."""
    return build_graph_memory(wl.arrow_lu_graph(2, 5, 3, seed=4), 2, 2,
                              criticality_order=True)


def _layered():
    return build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2,
                              criticality_order=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-device runs."""
    body = f"""
    import repro
    from repro.core import workloads as wl
    from repro.core.graph import reference_evaluate
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory

    def put(key, r):
        for k, v in sim_result(r).items():
            res[f"{{key}}/{{k}}"] = np.asarray(v)

    g = wl.arrow_lu_graph(2, 5, 3, seed=4)
    res["evaluate"] = np.asarray(reference_evaluate(g))
    gm = build_graph_memory(g, 2, 2, criticality_order=True)
    for p in {POLICIES!r}:
        put(f"arrow/{{p}}", repro.run(
            gm, OverlayConfig(scheduler=p, max_cycles=500_000)))
    cfgs = [OverlayConfig(**kw) for kw in {ARROW_BATCH!r}]
    for i, r in enumerate(repro.run(gm, batch=cfgs)):
        put(f"arrow_batch/{{i}}", r)
    gl = build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2,
                            criticality_order=True)
    put("layered", repro.run(gl, OverlayConfig(
        scheduler="ooo", max_cycles=100_000, check_every=8)))
    cfgs = [OverlayConfig(**kw) for kw in {LAYERED_BATCH!r}]
    for i, r in enumerate(repro.run(gl, batch=cfgs)):
        put(f"layered_batch/{{i}}", r)
    """
    return run_reference(tmp_path_factory, "distributed_1x1", body)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 1x1 CPU mesh over a gloo group of this one process."""
    with one_rank_mesh(tmp_path_factory.mktemp("mesh")) as m:
        yield m


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sched", POLICIES)
def test_every_policy_and_engine(mesh, reference, sched, engine):
    """``tests/test_chunked.py:127`` and ``tests/test_schedulers.py:122``:
    every policy under every engine (the tensor engine also at check_every
    8) equals the reference, and its values ``reference_evaluate``; the
    autotuned run equals the single-device run; no collective is
    launched."""
    gm = _arrow()
    distributed.reset_stats()
    for check_every in (8, None) if engine == "tensor" else (None,):
        cfg = OverlayConfig(scheduler=sched, max_cycles=500_000,
                            check_every=check_every, engine=engine)
        r = repro_torch.run(gm, cfg, mesh=mesh, device="cpu")
        assert r.done, (sched, check_every)
        assert_matches(r, reference, f"arrow/{sched}")
        np.testing.assert_array_equal(r.values, reference["evaluate"])
    assert_same_result(r, repro_torch.run(gm, cfg, device="cpu"), sched)
    assert distributed.stats == dict(halo=0, all_reduce=0, all_gather=0,
                                     halo_s=0.0)


def test_batch_matches_serial(mesh, reference):
    """``tests/test_chunked.py:146``: the batch of every policy and a
    ``scan`` frozen at its budget of 60 equals the reference's batch and
    the reference's solo runs of its configs, element for element."""
    gm = _arrow()
    cfgs = [OverlayConfig(**kw) for kw in ARROW_BATCH]
    rs = repro_torch.run(gm, mesh=mesh, batch=cfgs, device="cpu")
    assert len(rs) == len(cfgs)
    for i, r in enumerate(rs):
        assert_matches(r, reference, f"arrow_batch/{i}")
    assert not rs[-1].done and rs[-1].cycles == 60


@pytest.mark.parametrize("engine", ENGINES)
def test_layered_solo_and_batch(mesh, reference, engine):
    """``tests/test_megakernel.py:78``: ``ooo`` at check_every 8 and the
    batch of ``ooo`` and ``scan``, under each engine (the megakernel's plain
    version on the CPU)."""
    gl = _layered()
    cfg = OverlayConfig(scheduler="ooo", max_cycles=100_000, check_every=8,
                        engine=engine)
    r = repro_torch.run(gl, cfg, mesh=mesh, device="cpu")
    assert_matches(r, reference, "layered")
    assert_same_result(r, repro_torch.run(gl, cfg, device="cpu"), engine)
    cfgs = [OverlayConfig(engine=engine, **kw) for kw in LAYERED_BATCH]
    for i, r in enumerate(repro_torch.run(gl, mesh=mesh, batch=cfgs,
                                          device="cpu")):
        assert_matches(r, reference, f"layered_batch/{i}")


def test_deprecated_entry_points_warn(mesh):
    """The reference's deprecated names warn as its own do, and return what
    ``run(..., mesh=)`` returns."""
    gl = _layered()
    cfg = OverlayConfig(max_cycles=100_000)
    want = repro_torch.run(gl, cfg, mesh=mesh, device="cpu")
    with pytest.warns(DeprecationWarning, match="simulate_sharded is "
                      "deprecated"):
        got = distributed.simulate_sharded(gl, mesh, cfg, device="cpu")
    assert_same_result(got, want)
    with pytest.warns(DeprecationWarning, match="simulate_batch_sharded is "
                      "deprecated"):
        (got,) = distributed.simulate_batch_sharded(gl, mesh, [cfg],
                                                    device="cpu")
    assert_same_result(got, want)


def test_mesh_validation(mesh):
    """A mesh without the ``("data", "model")`` dims, a raw graph without a
    grid, a mixed batch and ``cfg`` with ``batch`` are refused, as the
    reference refuses them; a raw graph with a grid is placed as without a
    mesh."""
    g = wl.layered_dag(4, 6, seed=3)
    other = init_device_mesh("cpu", (1, 1), mesh_dim_names=("x", "y"))
    with pytest.raises(ValueError, match="dims named"):
        repro_torch.run(_layered(), mesh=other, device="cpu")
    with pytest.raises(ValueError, match="nx= and ny="):
        repro_torch.run(g, mesh=mesh, device="cpu")
    for knob, values in (("eject_capacity", (1, 2)),
                         ("engine", ("tensor", "select")),
                         ("telemetry", (None, TelemetrySpec()))):
        with pytest.raises(ValueError, match=f"uniform {knob}"):
            repro_torch.run(_layered(), mesh=mesh, device="cpu", batch=[
                OverlayConfig(**{knob: v}) for v in values])
    with pytest.raises(ValueError, match="wants_criticality_order"):
        repro_torch.run(g, mesh=mesh, nx=2, ny=2, device="cpu", batch=[
            OverlayConfig(scheduler=s) for s in ("ooo", "inorder")])
    with pytest.raises(ValueError, match="not both"):
        repro_torch.run(g, OverlayConfig(), mesh=mesh, batch=[],
                        device="cpu")
    cfg = OverlayConfig(scheduler="inorder")
    assert_same_result(
        repro_torch.run(g, cfg, mesh=mesh, nx=2, ny=2, device="cpu"),
        repro_torch.run(g, cfg, nx=2, ny=2, device="cpu"))
    assert distributed.route(mesh, "cpu").startswith("none")


def test_check_every_keys_on_mesh_size():
    """The autotune: 32 on a mesh of more than one device unless
    ``check_every`` is set, as the reference's ``resolve_check_every``."""
    from repro_torch.core.overlay import resolve_check_every

    cfg = OverlayConfig(engine="tensor")
    assert resolve_check_every(cfg, 2, 2, 64) == 8
    assert resolve_check_every(cfg, 2, 2, 64, num_devices=1) == 8
    assert resolve_check_every(cfg, 2, 2, 64, num_devices=8) == 32
    assert resolve_check_every(dataclasses.replace(cfg, check_every=7), 2, 2,
                               64, num_devices=8) == 7
