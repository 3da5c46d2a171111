"""One batched megakernel chunk handed over from the reference, leaf for
leaf.

The reference builds a batched state (its ``BatchedScheduler``, the vmapped
``init_one`` of ``_run_batch_jit``), runs it to cycle 17 with the vmapped
per-cycle body, dumps it, then applies one chunk of its batched Pallas
megakernel (``make_engine_chunk_fn(..., batched=True)``, 32 cycles,
interpret mode) and dumps the result. The port converts the cycle-17 state
(``state_from_numpy(..., batched=True)``), applies its batched chunk (the
plain version, on the CPU) and must reach the same state: every leaf,
the inactive members' substates included, float leaves as bit patterns.
Its ``init_batch_state`` must equal the reference's cycle-0 state too. On
``layered_dag`` two states pin the per-element repair: every element
completing inside the chunk (from cycle 20), and one element done before
it starts (from cycle 25).
"""
import dataclasses

import numpy as np
import pytest

from _torch_ref import (BATCH_CASES, EJECTS, MATRIX_GRAPH, assert_tree_equal,
                        batch_memory, run_reference, unflatten)
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import overlay, schedulers
from repro_torch.core.overlay import OverlayConfig
from repro_torch.kernels import megakernel

K = 32
#: (name, batch case, grid, eject, hand-over cycle). On the matrix graph
#: the batch runs ~1,100-8,700 cycles; on layered_dag its elements end at
#: cycles 24-28 and the budget-20 ``scan`` element is not frozen by a chunk.
CASES = [
    ("mixed", "chunked", (2, 2), "n_first_cap1", 17),
    ("mixed_priority", "chunked", (2, 2), "priority_cap1", 17),
    ("mixed_cap2", "chunked", (2, 2), "cap2", 17),
    ("layered_completes", "layered", (2, 2), "n_first_cap1", 20),
    ("layered_one_done", "layered", (2, 2), "n_first_cap1", 25),
]
IDS = [c[0] for c in CASES]


def _batch(case, grid, eject):
    """The port's graph, base config, member names, policy ids and select
    latencies of a case, as ``overlay._simulate_batch`` derives them."""
    graph, _, kws = BATCH_CASES[case]
    cap, pol = EJECTS[eject]
    cfgs = [OverlayConfig(eject_capacity=cap, eject_policy=pol, **kw)
            for kw in kws]
    names = tuple(dict.fromkeys(c.scheduler for c in cfgs))
    base = dataclasses.replace(cfgs[0], scheduler=names[0],
                               select_latency=None,
                               max_cycles=max(c.max_cycles for c in cfgs))
    g = overlay.device_graph(batch_memory(graph, *grid), device="cpu")
    W = g["opcode"].shape[2] // 32
    return (g, base, names, [names.index(c.scheduler) for c in cfgs],
            [schedulers.get(c.scheduler).sel_lat(c, W) for c in cfgs])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.core import schedulers
    from repro.core import workloads as wl
    from repro.core.overlay import (OverlayConfig, device_graph, init_state,
                                    make_cycle_fn, make_engine_chunk_fn)
    from repro.core.partition import build_graph_memory

    b, s, w, seed = {MATRIX_GRAPH!r}
    graphs = dict(arrow=wl.arrow_lu_graph(b, s, w, seed=seed),
                  layered=wl.layered_dag(4, 6, seed=3))
    ejects = {EJECTS!r}
    batch_cases = {BATCH_CASES!r}
    for name, case, (nx, ny), eject, start in {CASES!r}:
        graph, _, kws = batch_cases[case]
        cap, ep = ejects[eject]
        gm = build_graph_memory(graphs[graph], nx, ny, criticality_order=True)
        g = dict(device_graph(gm))
        cfgs = [OverlayConfig(eject_capacity=cap, eject_policy=ep, **kw)
                for kw in kws]
        names = tuple(dict.fromkeys(c.scheduler for c in cfgs))
        base = dataclasses.replace(
            cfgs[0], scheduler=names[0], select_latency=None,
            max_cycles=max(c.max_cycles for c in cfgs))
        sched = schedulers.BatchedScheduler(names)
        W = g["opcode"].shape[2] // 32
        pids = jnp.asarray([names.index(c.scheduler) for c in cfgs], jnp.int32)
        lats = jnp.asarray([schedulers.get(c.scheduler).sel_lat(c, W)
                            for c in cfgs], jnp.int32)

        def init_one(pid, lat):
            st = init_state(g, base, scheduler=sched)
            st["sched"]["policy_id"] = pid
            st["sel_lat"] = lat
            st["sel_wait"] = jnp.full_like(st["sel_wait"], lat - 1)
            return st

        st = jax.vmap(init_one)(pids, lats)
        res.update(flatten(st, f"{{name}}/init"))
        vcycle = jax.jit(jax.vmap(make_cycle_fn(g, base, scheduler=sched)))
        for _ in range(start):
            st = vcycle(st)
        res.update(flatten(st, f"{{name}}/start"))
        mega = dataclasses.replace(base, engine="megakernel")
        chunk = jax.jit(make_engine_chunk_fn(g, mega, {K}, scheduler=sched,
                                             batched=True))
        res.update(flatten(chunk(st), f"{{name}}/end"))
    """
    return run_reference(tmp_path_factory, "batch_handover", body)


def _float_bits(tree):
    """Float leaves as their int32 bit patterns (-0.0 differs from +0.0)."""
    return {k: _float_bits(v) if isinstance(v, dict)
            else v.view(np.int32) if v.dtype == np.float32 else v
            for k, v in tree.items()}


def _assert_same(got, want):
    assert_tree_equal(got, want)
    assert_tree_equal(_float_bits(got), _float_bits(want))


@pytest.mark.parametrize("name,case,grid,eject,start", CASES, ids=IDS)
def test_init_batch_state_matches_reference(reference, name, case, grid,
                                            eject, start):
    g, base, names, pids, lats = _batch(case, grid, eject)
    state = overlay.init_batch_state(g, base, names, pids, lats)
    _assert_same(state_to_numpy(state, batched=True),
                 unflatten(reference, f"{name}/init"))


@pytest.mark.parametrize("name,case,grid,eject,start", CASES, ids=IDS)
def test_convert_round_trip(reference, name, case, grid, eject, start):
    want = unflatten(reference, f"{name}/start")
    state = state_from_numpy(want, device="cpu", batched=True)
    nx, ny = grid
    assert tuple(state["link_e"].shape) == (len(BATCH_CASES[case][2]), 6,
                                            nx, ny)
    assert all(v.is_contiguous() for v in overlay.element(state, 0).values()
               if not isinstance(v, dict))
    _assert_same(state_to_numpy(state, batched=True), want)


@pytest.mark.parametrize("name,case,grid,eject,start", CASES, ids=IDS)
def test_chunk_handed_over_matches_reference(reference, name, case, grid,
                                             eject, start):
    g, base, names, _, _ = _batch(case, grid, eject)
    state = state_from_numpy(unflatten(reference, f"{name}/start"),
                             device="cpu", batched=True)
    assert state["cycle"].tolist() == [start] * len(BATCH_CASES[case][2])
    chunk = megakernel.make_mega_chunk_fn(
        g, dataclasses.replace(base, engine="megakernel"), K, names=names)
    got = state_to_numpy(chunk(state), batched=True)
    _assert_same(got, unflatten(reference, f"{name}/end"))
    if case == "layered":
        assert got["done"].all() and (got["cycle"] < start + K).all()
        assert len(set(got["cycle"].tolist())) > 1    # repaired per element
