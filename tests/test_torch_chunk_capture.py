"""The chunk that the card replays from a captured CUDA graph, on the CPU.

On the card the ``tensor`` and ``select`` engines capture
``overlay._into_state(chunk)`` (the chunk, with every leaf it returns copied
back into the state it was given) once and replay it per chunk
(``overlay.ReplayedChunk``). Here, without a card: ``_into_state`` of the
eager chunk equals the eager chunk bit for bit, leaf for leaf and in the
done trace, for both engines, every policy x eject configuration on the
matrix graph and a mixed batch; it leaves the result in the very tensors it
was given; and ``make_engine_chunk_fn`` on a CPU state is the eager chunk.

    PYTHONPATH=src python -m pytest -q tests/test_torch_chunk_capture.py
"""
import pytest
import torch

from repro_torch.core import overlay, schedulers
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import (OverlayConfig, device_graph,
                                      init_batch_state, init_state,
                                      make_batch_chunk_fn, make_chunk_fn,
                                      make_cycle_fn, make_engine_chunk_fn)
from repro_torch.core.partition import build_graph_memory

POLICIES = ("ooo", "inorder", "lru_flat", "scan")
EJECTS = {"n_first_cap1": (1, "n_first"), "priority_cap1": (1, "priority"),
          "cap2": (2, "n_first")}
K = 7
#: Solo cases (engine, eject, policy) and the mixed batch (policy "batch").
CASES = [(e, j, p) for e in ("tensor", "select") for j in EJECTS
         for p in (*POLICIES, "batch")]


def _graph(policy):
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy in ("ooo", "batch"))
    return device_graph(gm, device="cpu")


def _setup(engine, eject, policy):
    """(chunk with its done trace, start states): cycle 0, mid-run (40
    cycles in) and the mid-run state with every zero of its float planes
    made -0.0. ``policy="batch"`` is all four policies, ``ooo`` at select
    latency 4 and ``scan`` with a budget of 100, as one batch."""
    cap, pol = EJECTS[eject]
    g = _graph(policy)
    if policy == "batch":
        cfgs = [OverlayConfig(scheduler=p) for p in POLICIES] + [
            OverlayConfig(scheduler="ooo", select_latency=4),
            OverlayConfig(scheduler="scan", max_cycles=100)]
        base = OverlayConfig(scheduler=POLICIES[0], eject_capacity=cap,
                             eject_policy=pol, engine=engine)
        W = g["opcode"].shape[2] // 32
        s0 = init_batch_state(
            g, base, POLICIES, [POLICIES.index(c.scheduler) for c in cfgs],
            [schedulers.get(c.scheduler).sel_lat(c, W) for c in cfgs])
        cycle = make_cycle_fn(g, base,
                              scheduler=schedulers.BatchedScheduler(POLICIES))
        make = lambda k: make_batch_chunk_fn(cycle, k, with_trace=True)
    else:
        cfg = OverlayConfig(scheduler=policy, eject_capacity=cap,
                            eject_policy=pol, engine=engine)
        s0 = init_state(g, cfg)
        make = lambda k: make_chunk_fn(make_cycle_fn(g, cfg), k,
                                       with_trace=True)
    mid, _ = make(40)(overlay._clone(s0))
    zeros = overlay._clone(mid)
    for leaf in ("operands", "value"):
        zeros[leaf] = torch.where(zeros[leaf] == 0,
                                  torch.full_like(zeros[leaf], -0.0),
                                  zeros[leaf])
    return make(K), {"cycle 0": s0, "mid-run": mid, "signed zeros": zeros}


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _assert_bits_equal(got, want):
    got = dict(_leaves(got))
    for path, w in _leaves(want):
        g = got.pop(path)
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert not got, f"extra leaves {sorted(got)}"


@pytest.mark.parametrize("engine,eject,policy", CASES)
def test_into_state_equals_the_eager_chunk(engine, eject, policy):
    chunk, states = _setup(engine, eject, policy)
    step = overlay._into_state(chunk)
    for name, s in states.items():
        want, want_trace = chunk(overlay._clone(s))
        got, got_trace = step(overlay._clone(s))
        _assert_bits_equal(got, want)
        assert torch.equal(got_trace, want_trace), name


@pytest.mark.parametrize("policy", ("ooo", "batch"))
def test_into_state_returns_the_tensors_it_was_given(policy):
    chunk, states = _setup("select", "n_first_cap1", policy)
    s = states["mid-run"]
    given = dict(_leaves(s))
    cycle = int(s["cycle"].reshape(-1)[0])
    got, _ = overlay._into_state(chunk)(s)
    assert got is s
    for path, leaf in _leaves(got):
        assert leaf is given[path], path
    assert int(s["cycle"].reshape(-1)[0]) == cycle + K


@pytest.mark.parametrize("engine", ("tensor", "select"))
@pytest.mark.parametrize("batched", (False, True))
def test_engine_chunk_on_the_cpu_is_eager(engine, batched):
    """On a CPU state the engine's chunk is the eager chunk: no graph, a new
    state dict whose counters are new tensors, the same bits as
    ``make_chunk_fn``/``make_batch_chunk_fn``."""
    policy = "batch" if batched else "ooo"
    chunk, states = _setup(engine, "n_first_cap1", policy)
    g = _graph(policy)
    s = states["mid-run"]
    cfg = OverlayConfig(scheduler="inorder" if batched else "ooo",
                        engine=engine)
    got_fn = make_engine_chunk_fn(g, cfg, K,
                                  names=POLICIES if batched else None)
    assert not isinstance(got_fn, overlay.ReplayedChunk)
    want, _ = chunk(overlay._clone(s))
    start = s["busy_cycles"].clone()
    got = got_fn(s)
    _assert_bits_equal(got, want)
    if not batched:
        assert got is not s and got["busy_cycles"] is not s["busy_cycles"]
        assert torch.equal(s["busy_cycles"], start)
