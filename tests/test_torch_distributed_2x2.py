"""The sharded engines on a 2x2 mesh of four gloo ranks on the CPU, one
subprocess a rank (``_torch_ref.run_ranks``): on every rank each run of
``_torch_ref.MESH_RUNS`` equals the port's single-device run bit for bit
(every policy and engine, solo and batched, traced, check_every 1, 7 and
32); each rank's tile of one E and one S torus shift (a local roll, the edge
to the next rank) equals its tile of ``torch.roll`` over the whole grid; a
grid the mesh does not divide raises ``ValueError`` on every rank; and
``evaluate_placements(mesh=)`` equals the single-device evaluation (the
reference's ``tests/test_place.py:165`` on a mesh of four).
"""
import numpy as np
import pytest
import torch

from repro_torch import place
from repro_torch.core import workloads as wl

from _torch_ref import (MESH_RUNS, assert_mesh_run, assert_rank_matches,
                        mesh_config, mesh_runs)

PLACEMENTS = {"identity": None, "clustered": "clustered"}
PLACE_CFGS = [dict(), dict(select_latency=2)]

_EXTRA = f"""
mesh = mesh_of((2, 2))
# One torus shift of a 4x6 grid of packets, each tile [6, 2, 3].
ax, ay = distributed._mesh_axes(mesh, "data", "model", 4, 6)
full = torch.arange(6 * 4 * 6, dtype=torch.int32).reshape(6, 4, 6)
tile = full[:, 2 * ax.index:2 * ax.index + 2, 3 * ay.index:3 * ay.index + 3]
dev = torch.device("cpu")
res["tile"] = np.asarray([ax.index, ay.index])
res["shift_e"] = distributed._shard_shift(ax, 1, dev)(tile.clone()).numpy()
res["shift_s"] = distributed._shard_shift(ay, 2, dev)(tile.clone()).numpy()
try:
    repro_torch.run(build_graph_memory(g, 3, 4), mesh=mesh, device="cpu")
except ValueError as err:
    res["undivided"] = np.asarray(str(err))
out = place.evaluate_placements(
    g, 4, 4, {PLACEMENTS!r}, mesh=mesh, device="cpu",
    cfgs=[config(c) for c in {PLACE_CFGS!r}])
for name, rs in out.items():
    for i, r in enumerate(rs):
        put(f"place/{{name}}/{{i}}", r)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return mesh_runs(tmp_path_factory, "mesh_2x2", 4, [(2, 2)], _EXTRA)


@pytest.mark.parametrize("key", sorted(MESH_RUNS))
def test_every_rank_equals_single_device(ranks, key):
    assert_mesh_run(ranks, "2x2", key)


def test_halo_shift_equals_roll(ranks):
    full = torch.arange(6 * 4 * 6, dtype=torch.int32).reshape(6, 4, 6)
    seen = set()
    for res in ranks:
        i, j = res["tile"].tolist()
        seen.add((i, j))
        for key, dim in (("shift_e", 1), ("shift_s", 2)):
            want = torch.roll(full, 1, dims=dim)[:, 2 * i:2 * i + 2,
                                                 3 * j:3 * j + 3]
            np.testing.assert_array_equal(res[key], want.numpy(), err_msg=key)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_undivided_grid_raises(ranks):
    for res in ranks:
        assert "does not tile over the mesh" in str(res["undivided"])


def test_evaluate_placements(ranks):
    want = place.evaluate_placements(
        wl.arrow_lu_graph(2, 5, 3, seed=4), 4, 4, PLACEMENTS, device="cpu",
        cfgs=[mesh_config(c) for c in PLACE_CFGS])
    for res in ranks:
        for name, rs in want.items():
            for i, w in enumerate(rs):
                assert_rank_matches(res, f"place/{name}/{i}", w)
