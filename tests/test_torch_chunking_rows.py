"""The ``chunking`` rows of ``BENCH_overlay.json`` on the port, on the CPU:
Fig. 1's ``arrow_lu_graph(8, 10, 8, seed=3)`` (29,772 nodes) on the 16x16
grid under the default ``select`` engine, each policy on the memory layout
it wants, at check_every 1 (the per-cycle engine) and auto: ``ooo`` 3974
and ``inorder`` 4393 cycles, and both results equal bit for bit.
"""
import functools
import json

import numpy as np
import pytest

from _torch_ref import ROOT

import repro_torch
from repro_torch.core import schedulers
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory


@functools.lru_cache(maxsize=None)
def _memory(sched):
    g = wl.arrow_lu_graph(8, 10, 8, seed=3)
    return build_graph_memory(
        g, 16, 16,
        criticality_order=schedulers.get(sched).wants_criticality_order)


@functools.lru_cache(maxsize=None)
def _run(sched, check_every):
    return repro_torch.run(_memory(sched), OverlayConfig(
        scheduler=sched, check_every=check_every, max_cycles=8_000_000),
        device="cpu")


def _goldens(label):
    rows = json.loads((ROOT / "BENCH_overlay.json").read_text())[
        "chunking"]["rows"]
    return next(r for r in rows if r["name"] == f"chunking_{label}_n29772")[
        "cycles"]


@pytest.mark.parametrize("sched", ["ooo", "inorder"])
@pytest.mark.parametrize("check_every,label", [(1, "check_every_1"),
                                               (None, "check_every_auto")],
                         ids=["1", "auto"])
def test_chunking_rows(sched, check_every, label):
    r = _run(sched, check_every)
    assert r.done
    assert r.cycles == _goldens(label)[sched]
    assert r.cycles == {"ooo": 3974, "inorder": 4393}[sched]


@pytest.mark.parametrize("sched", ["ooo", "inorder"])
def test_check_every_is_exact(sched):
    a, b = _run(sched, 1), _run(sched, None)
    for f in ("cycles", "delivered", "deflections", "busy_cycles",
              "noc_deflections", "eject_deflections"):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.values.view(np.int32), b.values.view(np.int32))
