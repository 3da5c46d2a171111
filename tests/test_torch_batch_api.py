"""The batched sweep engine's front door and pieces, on the CPU: the
validation errors of ``run(batch=)`` (mirroring the reference's
``tests/test_schedulers.py:92-103``, ``tests/test_megakernel.py:171-176``
and ``tests/test_chunked.py:192-197``, on ``layered_dag`` where those use
``reduction_tree``), the composite ``BatchedScheduler``, the batched state's
layout and its conversion, the tail's freeze, and the batched megakernel
wrapper's leaf checks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import overlay, schedulers
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import megakernel

NAMES = ("inorder", "lru_flat", "ooo", "scan")


def _gm(criticality_order=True):
    return build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2,
                              criticality_order=criticality_order)


def _state(engine="tensor"):
    g = overlay.device_graph(_gm(), device="cpu")
    base = OverlayConfig(scheduler=NAMES[0], engine=engine)
    return g, base, overlay.init_batch_state(g, base, NAMES, [0, 1, 2, 3, 2],
                                             [1, 1, 1, 1, 4])


def _assert_equal(a, b):
    for k, v in b.items():
        if isinstance(v, dict):
            _assert_equal(a[k], v)
        else:
            assert torch.equal(a[k], v), k


@pytest.mark.parametrize("engines", [("tensor", "megakernel"),
                                     ("tensor", "select"),
                                     ("select", "megakernel")])
def test_rejects_mixed_engine(engines):
    with pytest.raises(ValueError, match="engine"):
        repro_torch.run(_gm(), batch=[OverlayConfig(engine=e) for e in engines],
                        device="cpu")


@pytest.mark.parametrize("knob,values", [("eject_capacity", (1, 2)),
                                         ("eject_policy", ("n_first",
                                                           "priority"))])
def test_rejects_mixed_eject(knob, values):
    with pytest.raises(ValueError, match=knob):
        repro_torch.run(_gm(), batch=[OverlayConfig(**{knob: v})
                                      for v in values], device="cpu")


def test_empty_batch():
    assert repro_torch.run(_gm(), batch=[], device="cpu") == []


def test_cfg_and_batch_are_exclusive():
    with pytest.raises(ValueError, match="batch"):
        repro_torch.run(_gm(), OverlayConfig(), batch=[OverlayConfig()],
                        device="cpu")


def test_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.run(_gm(), batch=[OverlayConfig()])


def test_raw_graph_needs_one_memory_layout():
    g = wl.layered_dag(4, 6, seed=3)
    with pytest.raises(ValueError, match="wants_criticality_order"):
        repro_torch.run(g, batch=[OverlayConfig(scheduler="ooo"),
                                  OverlayConfig(scheduler="inorder")],
                        nx=2, ny=2, device="cpu")
    # One layout: each element equals the solo run on the raw graph.
    cfgs = [OverlayConfig(scheduler="inorder"),
            OverlayConfig(scheduler="scan", select_latency=3)]
    for cfg, r in zip(cfgs, repro_torch.run(g, batch=cfgs, nx=2, ny=2,
                                            device="cpu")):
        solo = repro_torch.run(g, cfg, nx=2, ny=2, device="cpu")
        assert (r.cycles, r.deflections, r.busy_cycles) == (
            solo.cycles, solo.deflections, solo.busy_cycles)
        np.testing.assert_array_equal(r.values, solo.values)


def test_repeated_policies_share_one_member():
    """Names are de-duplicated in first-seen order; the base budget is the
    batch's largest; each element keeps its own latency and budget."""
    cfgs = [OverlayConfig(scheduler="scan", max_cycles=15),
            OverlayConfig(scheduler="ooo"),
            OverlayConfig(scheduler="scan", select_latency=2)]
    results = repro_torch.run(_gm(), batch=cfgs, device="cpu")
    assert [r.cycles for r in results][0] == 15 and not results[0].done
    for cfg, r in zip(cfgs, results):
        solo = repro_torch.run(_gm(), cfg, device="cpu")
        assert (r.cycles, r.done, r.delivered) == (solo.cycles, solo.done,
                                                   solo.delivered)


def test_batched_scheduler_layout_and_dispatch():
    g, base, state = _state()
    assert list(state["sched"]) == [*NAMES, "policy_id"]
    assert state["sched"]["policy_id"].tolist() == [0, 1, 2, 3, 2]
    assert state["sel_lat"].tolist() == [1, 1, 1, 1, 4]
    assert state["sel_wait"][4].unique().tolist() == [3]
    assert tuple(state["link_e"].shape) == (5, 6, 2, 2)
    for b in range(5):
        view = overlay.element(state, b)
        assert view["link_e"].is_contiguous()
        assert view["link_e"].data_ptr() == state["link_e"][b].data_ptr()
    # With one member the dispatch is pruned: the member's own hooks.
    solo = schedulers.BatchedScheduler(("ooo",))
    ooo = schedulers.get("ooo")
    slot = torch.full((2, 2), 5, dtype=torch.int32)
    ready = torch.tensor([[True, False], [False, True]])
    st = solo.on_ready(solo.init(g, base), slot, ready)
    idle = torch.ones(2, 2, dtype=torch.bool)
    gate = torch.tensor([[True, True], [False, True]])
    cand, have, out = solo.step(st, idle, gate)
    want, want_have, want_st = ooo.step(st["ooo"], idle, gate)
    assert torch.equal(cand, want) and torch.equal(have, want_have)
    assert have.any()
    _assert_equal(out["ooo"], want_st)
    assert torch.equal(solo.empty(out), ooo.empty(want_st))


def test_on_ready_goes_to_every_member_step_commits_the_active_one():
    g, base, state = _state()
    sched = schedulers.BatchedScheduler(NAMES)
    st = overlay.element(state, 2)["sched"]            # active member: ooo
    slot = torch.full((2, 2), 5, dtype=torch.int32)
    ready = torch.tensor([[True, False], [False, False]])
    out = sched.on_ready(st, slot, ready)
    assert int(out["inorder"]["size"][0, 0]) == int(st["inorder"]["size"][0, 0]) + 1
    for n in ("lru_flat", "ooo", "scan"):
        assert not torch.equal(out[n]["rdy"], st[n]["rdy"])
    gate = torch.ones(2, 2, dtype=torch.bool)
    _, _, stepped = sched.step(out, gate, gate)
    for n in ("inorder", "lru_flat", "scan"):
        _assert_equal(stepped[n], out[n])
    assert not torch.equal(stepped["ooo"]["rdy"], out["ooo"]["rdy"])


def test_convert_round_trip():
    _, _, state = _state()
    back = state_from_numpy(state_to_numpy(state, batched=True),
                            device="cpu", batched=True)
    _assert_equal(back, state)


def test_tail_freezes_halted_elements():
    g, base, state = _state()
    state = overlay.make_batch_chunk_fn(
        overlay.make_cycle_fn(g, base,
                              scheduler=schedulers.BatchedScheduler(NAMES)),
        10)(state)
    before = {k: v.clone() for k, v in state.items() if k != "sched"}
    budgets = torch.tensor([10, 11, 10, 50, 9], dtype=torch.int32)
    chunk = megakernel.make_mega_chunk_fn(
        g, dataclasses.replace(base, engine="megakernel"), 1, names=NAMES,
        max_cycles=budgets, with_trace=True)
    state, trace = chunk(state)
    assert state["cycle"].tolist() == [10, 11, 10, 11, 10]
    for b in (0, 2, 4):
        for k, v in before.items():
            assert torch.equal(state[k][b], v[b]), (b, k)
    assert trace.shape == (1, 5) and not trace.any()


def test_megakernel_batched_leaf_checks():
    g, base, state = _state(engine="megakernel")
    with pytest.raises(ValueError, match="no megakernel variant"):
        megakernel.make_mega_chunk_fn(g, base, 8, names=("ooo", "fifo"))
    with pytest.raises(ValueError, match="distinct"):
        megakernel.make_mega_chunk_fn(g, base, 8, names=("ooo", "ooo"))
    with pytest.raises(ValueError, match="names"):
        megakernel.make_mega_chunk_fn(g, base, 8, max_cycles=torch.zeros(
            5, dtype=torch.int32))
    chunk = megakernel.make_mega_chunk_fn(g, base, 8, names=NAMES)
    bad = dict(state, value=state["value"][:4].clone())
    with pytest.raises(ValueError, match="value"):
        chunk(bad)
    missing = dict(state, sched={k: v for k, v in state["sched"].items()
                                 if k != "scan"})
    with pytest.raises(ValueError, match="sched"):
        chunk(missing)
    frozen = megakernel.make_mega_chunk_fn(
        g, base, 1, names=NAMES, max_cycles=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="max_cycles"):
        frozen(state)
