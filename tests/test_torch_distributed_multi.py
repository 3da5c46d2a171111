"""The sharded engines on meshes of two gloo ranks on the CPU, one
subprocess a rank (``_torch_ref.run_ranks``): 1x2 and 2x1, an axis of size
1 beside a sharded one. On every rank each result equals the port's
single-device run bit for bit (cycles, ``done``, every stat counter, the
values as bit patterns, every trace leaf), under every policy and engine
(``megakernel`` runs the tensor chunk on a multi-shard mesh), solo and
batched, traced, at check_every 1, 7 and the mesh's 32
(``_torch_ref.MESH_RUNS``). The single-device runs are held to the reference
by the engine, batch and telemetry tests. The 2x2 mesh:
``tests/test_torch_distributed_2x2.py``; the 2x4 mesh against the
reference's own 2x4 run: ``tests/test_torch_distributed_2x4.py``.
"""
import pytest

from _torch_ref import MESH_RUNS, assert_mesh_run, mesh_runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return mesh_runs(tmp_path_factory, "mesh_1x2_2x1", 2, [(1, 2), (2, 1)])


@pytest.mark.parametrize("key", sorted(MESH_RUNS))
@pytest.mark.parametrize("tag", ["1x2", "2x1"])
def test_every_rank_equals_single_device(ranks, tag, key):
    assert_mesh_run(ranks, tag, key)
