"""The megakernel engine's host loop keeps one chunk queued: it enqueues
chunk n+1 before it reads chunk n's ``done``, while the budget allows both
(``core/overlay.py`` ``_run_chunks``). A chunk on a done state is a fixed
point, so every run must equal, leaf for leaf, the ``"tensor"`` engine at
``check_every=1`` (one cycle per host read, no chunks).

On the CPU the megakernel engine runs its plain chunk through the same host
loop. Runs start from a state handed over a few chunks before the end and
stop at budgets around the chunk edges: ``max_cycles`` = end - K - 1,
end - K, end - 1, end and end + K, solo and batched (a batch whose elements
end in different chunks, each at its own budget).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import overlay, schedulers
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import megakernel

K = 8
OFFSETS = (-K - 1, -K, -1, 0, K)
#: (grid side, policy, completion cycle) of the matrix graph's solo runs.
SOLO = ((2, "ooo", 1402), (4, "inorder", 633))
#: A batch on the 4x4 node-id layout whose elements end in different chunks
#: of K cycles: (policy, select latency, completion cycle).
BATCH = (("inorder", None, 633), ("lru_flat", None, 672),
         ("lru_flat", 2, 707))


def _matrix():
    return wl.arrow_lu_graph(3, 6, 4, seed=5)


def _clone(s):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in s.items()}


def _assert_leaves_equal(got, want, path=""):
    assert got.keys() == want.keys(), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_leaves_equal(g, w, f"{path}/{k}")
        elif w.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                f"{path}/{k}"
        else:
            assert torch.equal(g, w), f"{path}/{k}"


@pytest.fixture(scope="module")
def solo_starts():
    """Each solo case's device graph and the state 3K + 3 cycles before its
    end, made by the tensor engine."""
    out = {}
    for n, policy, end in SOLO:
        gm = build_graph_memory(_matrix(), n, n,
                                criticality_order=policy == "ooo")
        g = overlay.device_graph(gm, device="cpu")
        cfg = OverlayConfig(scheduler=policy, engine="tensor",
                            max_cycles=end - 3 * K - 3)
        out[policy] = g, overlay.run_state(g, cfg, overlay.init_state(g, cfg))
    return out


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n,policy,end", SOLO)
def test_solo_queued_chunks_equal_the_per_cycle_engine(solo_starts, n, policy,
                                                       end, offset):
    g, start = solo_starts[policy]
    budget = end + offset
    finals = {}
    for engine, every in (("megakernel", K), ("tensor", 1)):
        cfg = OverlayConfig(scheduler=policy, engine=engine,
                            check_every=every, max_cycles=budget)
        finals[engine] = overlay.run_state(g, cfg, _clone(start))
    _assert_leaves_equal(finals["megakernel"], finals["tensor"])
    assert int(finals["tensor"]["cycle"]) == min(end, budget)
    assert bool(finals["tensor"]["done"]) == (budget >= end)


def test_a_chunk_is_queued_past_done(solo_starts, monkeypatch):
    """With budget to spare, the loop has enqueued the chunk after the one
    that completes before it reads that one's ``done``: one chunk more than
    reading after every chunk needs, and the same state."""
    chunks = []
    make = megakernel.make_mega_chunk_fn

    def spy(g, cfg, check_every, **kw):
        fn = make(g, cfg, check_every, **kw)

        def chunk(s, *args, **kwargs):
            chunks.append(check_every)
            return fn(s, *args, **kwargs)
        return chunk

    monkeypatch.setattr(megakernel, "make_mega_chunk_fn", spy)
    g, start = solo_starts["ooo"]
    end = SOLO[0][2]
    cfg = OverlayConfig(scheduler="ooo", engine="megakernel", check_every=K,
                        max_cycles=end + 3 * K)
    final = overlay.run_state(g, cfg, _clone(start))
    # From end - 3K - 3 the fourth chunk completes; the fifth was queued.
    assert chunks == [K] * 5
    want = overlay.run_state(g, dataclasses.replace(
        cfg, engine="tensor", check_every=1), _clone(start))
    _assert_leaves_equal(final, want)
    assert int(final["cycle"]) == end and bool(final["done"])


@pytest.fixture(scope="module")
def batch_start():
    """The batch's device graph, member names, policy ids and select
    latencies, and its state 3K + 3 cycles before the first end."""
    gm = build_graph_memory(_matrix(), 4, 4, criticality_order=False)
    g = overlay.device_graph(gm, device="cpu")
    names = tuple(dict.fromkeys(p for p, _, _ in BATCH))
    W = g["opcode"].shape[2] // 32
    lats = [schedulers.get(p).sel_lat(OverlayConfig(scheduler=p,
                                                    select_latency=lat), W)
            for p, lat, _ in BATCH]
    base = OverlayConfig(scheduler=names[0], engine="tensor")
    state = overlay.init_batch_state(
        g, base, names, [names.index(p) for p, _, _ in BATCH], lats)
    first = min(e for _, _, e in BATCH) - 3 * K - 3
    state = overlay.run_batch_state(g, base, names, state,
                                    [first] * len(BATCH))
    return g, names, state


@pytest.mark.parametrize("offset", OFFSETS)
def test_batch_queued_chunks_equal_the_per_cycle_engine(batch_start, offset):
    g, names, start = batch_start
    ends = [e for _, _, e in BATCH]
    budgets = [e + offset for e in ends]
    finals = {}
    for engine, every in (("megakernel", K), ("tensor", 1)):
        base = OverlayConfig(scheduler=names[0], engine=engine,
                             check_every=every)
        finals[engine] = overlay.run_batch_state(g, base, names,
                                                 _clone(start), budgets)
    _assert_leaves_equal(finals["megakernel"], finals["tensor"])
    assert finals["tensor"]["cycle"].tolist() == [
        min(e, m) for e, m in zip(ends, budgets)]
    assert np.array_equal(finals["tensor"]["done"].numpy(),
                          np.array([m >= e for e, m in zip(ends, budgets)]))



def _signed_zeros(s):
    """``s`` with every zero of the float planes made -0.0. A cycle past
    completion still adds +0.0 at the cell of each eject port's (invalid)
    packet, which turns such a -0.0 into +0.0: a state on which a chunk
    after completion changes bits."""
    s = _clone(s)
    for leaf in ("operands", "value"):
        s[leaf] = torch.where(s[leaf] == 0, torch.full_like(s[leaf], -0.0),
                              s[leaf])
    return s


@pytest.mark.parametrize("n,policy,end", SOLO)
def test_solo_queued_chunk_after_done_at_a_chunk_edge(solo_starts, n, policy,
                                                      end):
    """From a state with signed zeros one cycle before completion, in
    chunks of one cycle: the chunk queued behind the one that completes
    must leave the state as the loop that reads ``done`` after every chunk
    (the tensor engine at the same K) leaves it."""
    g, start = solo_starts[policy]
    cfg = OverlayConfig(scheduler=policy, engine="tensor",
                        max_cycles=end - 1)
    edge = _signed_zeros(overlay.run_state(g, cfg, _clone(start)))
    finals = {}
    for engine in ("megakernel", "tensor"):
        run = dataclasses.replace(cfg, engine=engine, check_every=1,
                                  max_cycles=end + 2)
        finals[engine] = overlay.run_state(g, run, _clone(edge))
    _assert_leaves_equal(finals["megakernel"], finals["tensor"])
    assert int(finals["tensor"]["cycle"]) == end


def test_batch_queued_chunk_after_done_at_a_chunk_edge(batch_start):
    """The batched loop in chunks of one cycle from a state with signed
    zeros one cycle before the last element completes (the others done
    before, riding along): equal to the same chunks with the host reading
    ``done`` after every chunk (``_run_chunks`` at depth 1; the tensor
    engine at K = 1 freezes done elements cycle by cycle instead)."""
    g, names, start = batch_start
    last = max(e for _, _, e in BATCH)
    base = OverlayConfig(scheduler=names[0], engine="megakernel",
                         check_every=1)
    edge = _signed_zeros(overlay.run_batch_state(
        g, dataclasses.replace(base, engine="tensor", check_every=K), names,
        _clone(start), [last - 1] * len(BATCH)))
    budgets = [last + 2] * len(BATCH)
    got = overlay.run_batch_state(g, base, names, _clone(edge), budgets)
    want = _clone(edge)
    want, cycle, done = overlay._run_chunks(
        megakernel.make_mega_chunk_fn(g, base, 1, names=names), want,
        want["cycle"].tolist(), want["done"].tolist(), budgets, 1, 1)
    _assert_leaves_equal(got, want)
    assert cycle == [e for _, _, e in BATCH] and all(done)
