"""CPU tests of the benchmark's yardstick: the frozen arrow-LU generator
against the port's, the frozen bytes bounds against hand counts and the
port's own state, and the plain reference against the port and the repo's
goldens, at small sizes."""
from __future__ import annotations

import numpy as np
import pytest

from bench_port import arrow_lu, bounds, overlay_ref


@pytest.mark.parametrize("args", [(2, 3, 2), (3, 6, 4)])
def test_frozen_generator_is_the_ports(args):
    from repro_torch.core import workloads

    s = arrow_lu.structure(*args)
    g = workloads.arrow_lu_graph(*args, seed=3)
    for key in ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot"):
        assert np.array_equal(s[key], getattr(g, key)), key
    assert np.array_equal(arrow_lu.input_values(s, 3).view(np.int32),
                          g.initial_values.view(np.int32))


def test_values_follow_the_seed():
    s = arrow_lu.structure(2, 3, 2)
    a, b = (arrow_lu.input_values(s, k) for k in (2 ** 31 + 7, 8))
    assert np.array_equal(a, arrow_lu.input_values(s, 2 ** 31 + 7))
    assert not np.array_equal(a, b)
    assert np.array_equal(a == 0, b == 0)          # the same fill-in zeros
    assert arrow_lu.input_values(s, -5).dtype == np.float32


def test_bounds_are_the_hand_counts():
    # 2 PEs of 1 word; ooo over 40 cycles (2 chunks of 32), 5 packets
    # delivered, 3 nodes fired, 4 picks.
    chunk = 2 * (2 * 48 + 2 * 16 + 2 * 4) + 32
    assert bounds.mega_sim_bytes(2, 1, "ooo", 40, 5, 3, 4) == (
        2 * chunk + 5 * 16 + 3 * 8 + 4 * 8)
    # inorder holds head and size a PE, and pushes and pops each pick.
    chunk = 2 * (2 * 48 + 2 * 16 + 2 * 8) + 32
    assert bounds.mega_sim_bytes(2, 1, "inorder", 32, 5, 3, 4) == (
        chunk + 5 * 16 + 3 * 8 + 4 * 16)
    assert bounds.sched_chunk_bytes("scan", 2, 3) == 4 * 6 + 8
    assert bounds.lod_schedule_bytes(256, 4) == 4096 + 256 + 1024 + 4096
    assert bounds.lod_rotating_bytes(256, 4) == 4096 + 1024 + 256 + 1024 + 4096


@pytest.mark.parametrize("policy", ["ooo", "inorder", "scan"])
def test_bounds_count_the_ports_leaves(policy):
    """What a chunk holds on chip is the port's state leaves of that name,
    and a finished simulation's counters give the packets and fires."""
    import repro_torch
    from repro_torch.core import overlay
    from repro_torch.core.partition import build_graph_memory
    from repro_torch.core.workloads import arrow_lu_graph

    graph = arrow_lu_graph(3, 6, 4, seed=3)
    gm = build_graph_memory(graph, 4, 4,
                            criticality_order=policy == "ooo")
    g = overlay.device_graph(gm, "cpu")
    state = overlay.init_state(g, overlay.OverlayConfig(scheduler=policy))

    def nbytes(*names):
        return sum(state[n].numel() * state[n].element_size() for n in names)

    P = 16
    assert nbytes("link_e", "link_s") == bounds.LINK_BYTES * P
    assert nbytes("active", "cursor", "cursor_end", "sel_wait") == (
        bounds.PE_BYTES * P)
    sched = sum(v.numel() * v.element_size() for k, v in
                state["sched"].items() if k != "fifo")
    assert sched == bounds.sched_chunk_bytes(policy, P, gm.words)
    res = repro_torch.run(gm, overlay.OverlayConfig(scheduler=policy,
                                                    engine="tensor"),
                          device="cpu")
    ops = graph.opcode
    assert res.delivered == graph.fanout_dst.shape[0]
    assert res.busy_cycles == int((ops != 0).sum())


def test_reference_is_the_port_on_a_4x4_grid():
    import repro_torch
    from repro_torch.core.graph import DataflowGraph
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    s = arrow_lu.structure(3, 6, 4)
    values = arrow_lu.input_values(s, 99)
    g = DataflowGraph(opcode=s["opcode"], fanout_ptr=s["fanout_ptr"],
                      fanout_dst=s["fanout_dst"], fanout_slot=s["fanout_slot"],
                      initial_values=values)
    prep = overlay_ref.prepare(s)
    runs = [dict(scheduler="ooo", select_latency=2, layout="criticality"),
            dict(scheduler="scan", select_latency=3, layout="fifo")]
    want = overlay_ref.simulate(s, prep, 4, 4, runs)
    ref_values = overlay_ref.evaluate(s, prep, values)
    for r, w in zip(runs, want):
        gm = build_graph_memory(g, 4, 4,
                                criticality_order=r["layout"] == "criticality")
        got = repro_torch.run(gm, OverlayConfig(
            scheduler=r["scheduler"], select_latency=r["select_latency"],
            engine="tensor"), device="cpu")
        assert {k: getattr(got, k) for k in w} == w
        assert np.array_equal(got.values, ref_values)


def test_reference_reproduces_the_goldens():
    """``arrow_lu_graph(4, 10, 8)`` on 16x16: the repo's n15072 goldens."""
    s = arrow_lu.structure(4, 10, 8)
    out = overlay_ref.simulate(s, overlay_ref.prepare(s), 16, 16, [
        dict(scheduler="ooo", select_latency=1, layout="criticality"),
        dict(scheduler="inorder", select_latency=1, layout="fifo")])
    assert [o["cycles"] for o in out] == [2125, 2369]
    assert all(o["done"] for o in out)
