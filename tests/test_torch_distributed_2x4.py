"""The sharded engine on the reference's own 2x4 mesh, on the CPU: eight
gloo ranks (one subprocess each, ``_torch_ref.run_ranks``) against the
reference's run on eight fake host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), run side by side.
The counterparts of the reference's ``tests/test_chunked.py``
``SHARDED_SCRIPT`` (``arrow_lu_graph(4, 8, 6, seed=2)`` on 4x8,
``check_every=7``, and the batch of ``ooo``, ``inorder`` and ``scan`` at a
budget of 200) and ``tests/test_overlay_sharded.py`` (the autotuned chunk;
values against ``reference_evaluate`` to 1e-5): on every rank each result
equals the reference's 2x4 run bit for bit, and the solo runs the port's
single-device run.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro_torch
from repro_torch.core import workloads as wl
from repro_torch.core.graph import reference_evaluate
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory

from _torch_ref import (RESULT_KEYS, assert_matches, assert_rank_matches,
                        run_ranks, run_reference)

#: key -> config keywords (a list of them for a batch).
RUNS = {
    "K7": dict(scheduler="ooo", max_cycles=500_000, check_every=7),
    "auto": dict(scheduler="ooo", max_cycles=500_000),
    "batch": [dict(scheduler="ooo", max_cycles=500_000),
              dict(scheduler="inorder", max_cycles=500_000),
              dict(scheduler="scan", max_cycles=200)],
}

_SETUP = """
g = wl.arrow_lu_graph(4, 8, 6, seed=2)
gm = build_graph_memory(g, 4, 8, criticality_order=True)
for key, kw in RUNS.items():
    if isinstance(kw, list):
        for i, r in enumerate(repro_run(gm, batch=[OverlayConfig(**c)
                                                   for c in kw])):
            put(f"{key}/{i}", r)
    else:
        put(key, repro_run(gm, OverlayConfig(**kw)))
"""

_PORT = f"""
import repro_torch
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory

RUNS = {RUNS!r}
mesh = mesh_of((2, 4))


def repro_run(*args, **kw):
    return repro_torch.run(*args, mesh=mesh, device="cpu", **kw)

{_SETUP}
"""

_REFERENCE = f"""
import jax
import repro
from repro.core import workloads as wl
from repro.core.overlay import OverlayConfig
from repro.core.partition import build_graph_memory

RUNS = {RUNS!r}
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"))


def put(key, r):
    for k, v in sim_result(r).items():
        res[f"{{key}}/{{k}}"] = np.asarray(v)


def repro_run(*args, **kw):
    return repro.run(*args, mesh=mesh, **kw)

{_SETUP}
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the reference's), run at the same time."""
    # Both threads call ``mktemp``. Made here first, pytest's base temp dir
    # is not created by two threads at once (the loser's mkdir raises).
    tmp_path_factory.getbasetemp()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_ranks, tmp_path_factory, "mesh_2x4", 8, _PORT)
        ref = pool.submit(
            run_reference, tmp_path_factory, "reference_2x4", _REFERENCE,
            env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
        return ranks.result(), ref.result()


def _keys(key):
    kw = RUNS[key]
    return [f"{key}/{i}" for i in range(len(kw))] if isinstance(kw, list) \
        else [key]


@pytest.mark.parametrize("key", sorted(RUNS))
def test_every_rank_equals_reference_2x4(runs, key):
    ranks, ref = runs
    for k in _keys(key):
        for res in ranks:
            for f in RESULT_KEYS:
                got, want = res[f"{k}/{f}"], ref[f"{k}/{f}"]
                if f == "values":
                    np.testing.assert_array_equal(
                        got.view(np.int32), want.view(np.int32),
                        err_msg=f"{k} values")
                else:
                    assert got.item() == want.item(), (k, f, got, want)
    if key == "batch":
        assert [bool(ref[f"batch/{i}/done"]) for i in range(3)] == [
            True, True, False]
        assert int(ref["batch/2/cycles"]) == 200


@pytest.mark.parametrize("key", ["K7", "auto"])
def test_solo_equals_single_device(runs, key):
    ranks, _ = runs
    g = wl.arrow_lu_graph(4, 8, 6, seed=2)
    gm = build_graph_memory(g, 4, 8, criticality_order=True)
    want = repro_torch.run(gm, OverlayConfig(**RUNS[key]), device="cpu")
    assert want.done
    np.testing.assert_allclose(want.values, reference_evaluate(g),
                               rtol=1e-5, atol=1e-5)
    for res in ranks:
        assert_rank_matches(res, key, want)
