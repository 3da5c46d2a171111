"""The port's CUDA kernels, its select and megakernel engines (the chunks of
the tensor and select engines replayed from captured CUDA graphs among
them, and the traced megakernel and traced chunks) and its flash-attention
kernel on a card.
Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor the reference package, so it runs on a machine that has only
torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import workloads as wl
from repro_torch.core.graph import reference_evaluate
from repro_torch.core.overlay import (OverlayConfig, device_graph, init_state,
                                      run_state)
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lod, megakernel

pytestmark = pytest.mark.cuda

# Reference cycle/deflection counts of arrow_lu_graph(3, 6, 4, seed=5) on 2x2.
GOLDENS = {"ooo": (1402, 2358), "inorder": (1507, 2508),
           "lru_flat": (1486, 2328), "scan": (8664, 161)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(p, w, seed, device):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(p, w), dtype=np.uint32)
    bits[rng.random((p, w)) < 0.5] = 0
    bits[rng.random((p, w)) < 0.1] |= np.uint32(0x80000000)
    bits[0] = 0
    ptr = rng.integers(0, w * 32, size=p).astype(np.int32)
    ptr[:4] = np.array([0, 31, 32, w * 32 - 1]) % (w * 32)
    gates = [None, np.ones(p, bool), np.zeros(p, bool), rng.random(p) < 0.5]
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return t(bits.view(np.int32)), t(ptr), [t(g) for g in gates]


@pytest.mark.parametrize("p,w", [(256, 2), (256, 4), (256, 15), (1024, 64)])
def test_kernels_match_plain_versions(cuda, p, w):
    bits, ptr, gates = _inputs(p, w, seed=w, device=cuda)
    lod.reset_launches()
    pairs = [((lod.lod(bits),), (lod.lod_plain(bits),))]
    for gate in gates:
        pairs.append((lod.schedule_step(bits, gate),
                      lod.schedule_step_plain(bits, gate)))
        pairs.append((lod.rotating_schedule_step(bits, ptr, gate),
                      lod.rotating_schedule_step_plain(bits, ptr, gate)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lod.launches == {"lod": 1, "schedule_step": 4,
                            "rotating_schedule_step": 4}


#: The leading-one kernel each policy's pick launches under "select".
KERNEL_OF = {"ooo": "schedule_step", "scan": "rotating_schedule_step",
             "lru_flat": "rotating_schedule_step"}


@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_select_engine_reproduces_goldens(cuda, policy):
    g = wl.arrow_lu_graph(3, 6, 4, seed=5)
    lod.reset_launches()
    r = repro_torch.run(g, OverlayConfig(scheduler=policy, engine="select"),
                        nx=2, ny=2)
    assert r.done
    assert (r.cycles, r.deflections) == GOLDENS[policy]
    assert (r.busy_cycles, r.delivered) == (1777, 3554)
    np.testing.assert_allclose(r.values, reference_evaluate(g),
                               rtol=1e-5, atol=1e-5)
    kernel = KERNEL_OF.get(policy)
    if kernel is not None:
        assert lod.launches[kernel] > 0
    # The tensor engine on the card gives the same bits.
    t = repro_torch.run(g, OverlayConfig(scheduler=policy, engine="tensor"),
                        nx=2, ny=2)
    assert (t.cycles, t.deflections) == (r.cycles, r.deflections)
    np.testing.assert_array_equal(t.values, r.values)


EJECTS = {"n_first_cap1": (1, "n_first"), "priority_cap1": (1, "priority"),
          "cap2": (2, "n_first")}


def _clone(s):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in s.items()}


def _assert_bits_equal(got, want, path=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_bits_equal(got[k], w, f"{path}/{k}")
        elif w.dtype == torch.float32:
            assert torch.equal(got[k].view(torch.int32),
                               w.view(torch.int32)), f"{path}/{k}"
        else:
            assert torch.equal(got[k], w), f"{path}/{k}"


@pytest.mark.parametrize("eject", sorted(EJECTS))
@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_megakernel_matches_plain_chunk(cuda, policy, eject):
    """The kernel's chunk equals the plain chunk bit for bit, every state
    leaf and the done trace, from cycle 0, mid-run, near the end and a
    state whose float planes hold -0.0, at K = 1, 7 and 32, on both bodies
    (the plan's ``shared`` and the forced ``global``)."""
    cap, pol = EJECTS[eject]
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy == "ooo")
    g = device_graph(gm, device=cuda)
    cfg = OverlayConfig(scheduler=policy, eject_capacity=cap,
                        eject_policy=pol, engine="megakernel")
    s0 = init_state(g, cfg)
    end = int(run_state(g, cfg, _clone(s0))["cycle"])
    late = run_state(g, OverlayConfig(
        scheduler=policy, eject_capacity=cap, eject_policy=pol,
        engine="megakernel", max_cycles=end - 3), _clone(s0))
    mid = megakernel.mega_chunk_plain(g, cfg, 40)(_clone(s0))
    zeros = _clone(mid)
    for leaf in ("operands", "value"):
        zeros[leaf] = torch.where(zeros[leaf] == 0,
                                  torch.full_like(zeros[leaf], -0.0),
                                  zeros[leaf])
    for state in (s0, mid, late, zeros):
        for k in (1, 7, 32):
            want, want_trace = megakernel.mega_chunk_plain(
                g, cfg, k, with_trace=True)(_clone(state))
            for body in ("shared", "global"):
                megakernel.reset_launches()
                got, got_trace = megakernel.make_mega_chunk_fn(
                    g, cfg, k, with_trace=True, body=body)(_clone(state))
                torch.cuda.synchronize()
                assert megakernel.launches["mega_chunk"] == 1
                assert megakernel.launches[f"mega_chunk_{body}"] == 1
                _assert_bits_equal(got, want)
                assert torch.equal(got_trace, want_trace)


@pytest.mark.parametrize("policy", ("ooo", "lru_flat", "scan"))
def test_global_body_on_deep_rows_and_large_grids(cuda, policy):
    """The global body against the plain chunk where the shared body does
    not go: rows of 40,960 slots (1,280 RDY words, 40 summary words: the
    three-level pick) with RDY bits scattered over the whole row and the
    rotating pointers anywhere, and the matrix graph on 64x64 (4,096 PEs, a
    loop over PEs a thread)."""
    rng = np.random.default_rng(7)
    cases = []
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy == "ooo",
                            min_lmax=40960)
    g = device_graph(gm, device=cuda)
    cfg = OverlayConfig(scheduler=policy, engine="megakernel")
    mid = megakernel.mega_chunk_plain(g, cfg, 40)(init_state(g, cfg))
    rdy = mid["sched"]["rdy"]
    bits = rng.integers(0, 2**32, size=rdy.shape, dtype=np.uint32)
    bits[rng.random(rdy.shape) < 0.97] = 0
    rdy |= torch.from_numpy(bits.view(np.int32)).to(cuda)
    if "ptr" in mid["sched"]:
        mid["sched"]["ptr"].copy_(torch.from_numpy(rng.integers(
            0, 40960, size=mid["sched"]["ptr"].shape).astype(np.int32)))
    cases.append((g, cfg, mid))
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 64, 64,
                            criticality_order=policy == "ooo")
    g = device_graph(gm, device=cuda)
    cases.append((g, cfg, megakernel.mega_chunk_plain(g, cfg, 40)(
        init_state(g, cfg))))
    for g, cfg, state in cases:
        nx, ny, L = g["opcode"].shape
        assert megakernel.plan(nx, ny, L, (policy,)).body == "global"
        for k in (1, 7, 32):
            want, want_trace = megakernel.mega_chunk_plain(
                g, cfg, k, with_trace=True)(_clone(state))
            megakernel.reset_launches()
            got, got_trace = megakernel.make_mega_chunk_fn(
                g, cfg, k, with_trace=True)(_clone(state))
            torch.cuda.synchronize()
            assert megakernel.launches["mega_chunk_global"] == 1
            _assert_bits_equal(got, want)
            assert torch.equal(got_trace, want_trace)


def test_queued_chunk_after_done_leaves_the_state(cuda):
    """From a state with signed zeros one cycle before completion, in
    chunks of one cycle, solo and batched: the chunk queued behind the one
    that completes changes nothing (the kernel reads the flags the chunk
    before it left in device memory), as the loop that reads ``done`` after
    every chunk would have it."""
    from repro_torch.core import overlay

    def signed_zeros(s):
        for leaf in ("operands", "value"):
            s[leaf] = torch.where(s[leaf] == 0,
                                  torch.full_like(s[leaf], -0.0), s[leaf])
        return s

    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=True)
    g = device_graph(gm, device=cuda)
    end = GOLDENS["ooo"][0]
    cfg = OverlayConfig(scheduler="ooo", engine="megakernel", check_every=1,
                        max_cycles=end - 1)
    edge = signed_zeros(run_state(g, cfg, init_state(g, cfg)))
    finals = {}
    for engine in ("megakernel", "tensor"):
        run = OverlayConfig(scheduler="ooo", engine=engine, check_every=1,
                            max_cycles=end + 2)
        finals[engine] = run_state(g, run, _clone(edge))
    torch.cuda.synchronize()
    _assert_bits_equal(finals["megakernel"], finals["tensor"])
    # Batched, the others done before the last and riding along.
    from repro_torch.core import schedulers

    names = ("ooo", "inorder", "lru_flat")
    one = OverlayConfig(scheduler=names[0], engine="megakernel",
                        check_every=1)
    state = overlay.init_batch_state(
        g, one, names, [0, 1, 2],
        [schedulers.get(n).sel_lat(OverlayConfig(scheduler=n),
                                   g["opcode"].shape[2] // 32)
         for n in names])
    last = max(overlay.run_batch_state(g, one, names, _clone(state),
                                       [10**6] * 3)["cycle"].tolist())
    edge = signed_zeros(overlay.run_batch_state(g, one, names, state,
                                                [last - 1] * 3))
    budgets = [last + 2] * 3
    got = overlay.run_batch_state(g, one, names, _clone(edge), budgets)
    want = _clone(edge)
    want, _, _ = overlay._run_chunks(
        megakernel.make_mega_chunk_fn(g, one, 1, names=names), want,
        want["cycle"].tolist(), want["done"].tolist(), budgets, 1, 1)
    torch.cuda.synchronize()
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("offset", (-9, -8, -1, 0, 8))
def test_queued_chunks_equal_the_per_cycle_engine(cuda, offset):
    """The megakernel engine's host loop (chunk n + 1 queued before chunk
    n's done flags, read from pinned memory the kernel writes) against the
    tensor engine at check_every=1, at budgets around the chunk edges."""
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=True)
    g = device_graph(gm, device=cuda)
    end = GOLDENS["ooo"][0]
    finals = {}
    for engine, every in (("megakernel", 8), ("tensor", 1)):
        cfg = OverlayConfig(scheduler="ooo", engine=engine, check_every=every,
                            max_cycles=end + offset)
        finals[engine] = run_state(g, cfg, init_state(g, cfg))
    torch.cuda.synchronize()
    _assert_bits_equal(finals["megakernel"], finals["tensor"])
    assert int(finals["tensor"]["cycle"]) == min(end, end + offset)


@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_megakernel_engine_reproduces_goldens(cuda, policy):
    g = wl.arrow_lu_graph(3, 6, 4, seed=5)
    megakernel.reset_launches()
    r = repro_torch.run(g, OverlayConfig(scheduler=policy,
                                         engine="megakernel"), nx=2, ny=2)
    assert r.done
    assert (r.cycles, r.deflections) == GOLDENS[policy]
    assert (r.busy_cycles, r.delivered) == (1777, 3554)
    assert megakernel.launches["mega_chunk"] > 0
    t = repro_torch.run(g, OverlayConfig(scheduler=policy, engine="tensor"),
                        nx=2, ny=2)
    np.testing.assert_array_equal(r.values.view(np.int32),
                                  t.values.view(np.int32))


BATCH_POLICIES = ("inorder", "lru_flat", "ooo", "scan")


def _mixed_batch(g, cap, pol):
    """All four policies, ``ooo`` at select latency 4 and ``scan`` with a
    short budget, on one memory layout: (base config, names, state)."""
    from repro_torch.core import schedulers
    from repro_torch.core.overlay import init_batch_state

    W = g["opcode"].shape[2] // 32
    cfgs = [OverlayConfig(scheduler=p) for p in BATCH_POLICIES] + [
        OverlayConfig(scheduler="ooo", select_latency=4),
        OverlayConfig(scheduler="scan", max_cycles=100)]
    base = OverlayConfig(scheduler=BATCH_POLICIES[0], eject_capacity=cap,
                         eject_policy=pol, engine="megakernel")
    state = init_batch_state(
        g, base, BATCH_POLICIES,
        [BATCH_POLICIES.index(c.scheduler) for c in cfgs],
        [schedulers.get(c.scheduler).sel_lat(c, W) for c in cfgs])
    return base, cfgs, state


@pytest.mark.parametrize("eject", sorted(EJECTS))
def test_batched_megakernel_matches_plain_chunk(cuda, eject):
    """The batched kernel equals ``mega_batch_chunk_plain`` bit for bit,
    every leaf and the [K, B] trace, on a mixed batch from cycle 0, mid-run,
    each element 3 cycles before its end and a state with -0.0 in its float
    planes, at K = 1, 7 and 32; and a one-cycle tail launch that freezes the
    elements at their budgets."""
    from repro_torch.core.overlay import run_batch_state

    cap, pol = EJECTS[eject]
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=True)
    g = device_graph(gm, device=cuda)
    base, cfgs, s0 = _mixed_batch(g, cap, pol)
    budgets = [c.max_cycles for c in cfgs]
    end = run_batch_state(g, base, BATCH_POLICIES, _clone(s0), budgets)
    ends = end["cycle"].tolist()
    late = run_batch_state(g, base, BATCH_POLICIES, _clone(s0),
                           [min(m, e - 3) for m, e in zip(budgets, ends)])
    mid = megakernel.mega_batch_chunk_plain(g, base, 40,
                                            BATCH_POLICIES)(_clone(s0))
    zeros = _clone(mid)
    for leaf in ("operands", "value"):
        zeros[leaf] = torch.where(zeros[leaf] == 0,
                                  torch.full_like(zeros[leaf], -0.0),
                                  zeros[leaf])
    for state in (s0, mid, late, zeros):
        for k in (1, 7, 32):
            want, want_trace = megakernel.mega_batch_chunk_plain(
                g, base, k, BATCH_POLICIES, with_trace=True)(_clone(state))
            megakernel.reset_launches()
            got, got_trace = megakernel.make_mega_chunk_fn(
                g, base, k, names=BATCH_POLICIES, with_trace=True)(
                _clone(state))
            torch.cuda.synchronize()
            assert megakernel.launches["mega_chunk_batched"] == 1
            _assert_bits_equal(got, want)
            assert torch.equal(got_trace, want_trace)
    frozen = torch.tensor([40, 10_000, 41, 40, 10_000, 100],
                          dtype=torch.int32, device=cuda)
    want, want_trace = megakernel.mega_batch_chunk_plain(
        g, base, 1, BATCH_POLICIES, with_trace=True,
        max_cycles=frozen)(_clone(mid))
    got, got_trace = megakernel.make_mega_chunk_fn(
        g, base, 1, names=BATCH_POLICIES, with_trace=True,
        max_cycles=frozen)(_clone(mid))
    _assert_bits_equal(got, want)
    assert torch.equal(got_trace, want_trace)


def test_policy_sweep_goldens_through_batch(cuda):
    """The reference's ``policy_sweep`` at 29,772 nodes on 16x16 through
    ``run(batch=)`` with the megakernel: inorder, lru_flat and scan as one
    batch on the node-id layout, ooo on the criticality layout."""
    g = wl.arrow_lu_graph(8, 10, 8, seed=3)
    goldens = {"inorder": 4393, "lru_flat": 4344, "scan": 4625, "ooo": 3974}
    megakernel.reset_launches()
    got = {}
    for group in (("inorder", "lru_flat", "scan"), ("ooo",)):
        cfgs = [OverlayConfig(scheduler=p, engine="megakernel") for p in group]
        for p, r in zip(group, repro_torch.run(g, batch=cfgs, nx=16, ny=16)):
            assert r.done
            got[p] = r.cycles
    assert got == goldens
    assert megakernel.launches["mega_chunk_batched"] > 0


# (b, tq, tkv, hq, hkv, d, causal, kv_len, (body in float32, in bfloat16)):
# causal prefills with Tq < Tkv over ragged tiles (Tq 33 and 2047, Tkv 70
# and 2049), head_dim 80 non-causal with ragged kv_len (the non-causal form
# of whisper's encoder and cross-attention, at another head_dim), 128 with
# ragged kv_len and 256 under GQA; rep-7 decode steps with ragged cache
# lengths (1, 64, 65 and the full 2080).
PREFILL, DECODE = ("simt", "mma"), ("split", "split")
FLASH_CASES = [(2, 33, 70, 4, 2, 64, True, None, PREFILL),
               (3, 1, 90, 14, 2, 64, True, [1, 90, 45], DECODE),
               (1, 2047, 2049, 14, 2, 64, True, None, PREFILL),
               (2, 100, 70, 6, 2, 80, False, [70, 33], PREFILL),
               (3, 70, 2049, 8, 2, 128, True, [70, 2049, 1000], PREFILL),
               (1, 130, 200, 4, 2, 256, True, None, PREFILL),
               (4, 1, 2080, 14, 2, 64, True, [1, 64, 65, 2080], DECODE),
               # zamba2-7b's shared attention: 32 heads of 112 (the mma body
               # pads them to its 128 instantiation), prefill and decode
               (2, 2048, 2048, 32, 32, 112, True, None, PREFILL),
               (8, 1, 2080, 32, 32, 112, True,
                [1, 2080, 2049, 1500, 777, 64, 65, 2079], DECODE),
               # qwen2-vl-72b's: 64 q over 8 kv heads of 128 (8 rows a kv
               # head in decode)
               (2, 2048, 2048, 64, 8, 128, True, None, PREFILL),
               (8, 1, 2080, 64, 8, 128, True,
                [1, 2080, 2049, 1500, 777, 64, 65, 2079], DECODE),
               # whisper-large-v3's (20 heads of 64 over 20; 1,500 frames,
               # not a multiple of the 64-key tiles, a 750-token prompt):
               # the encoder's non-causal self-attention, the decoder's
               # causal prefill, the cross-attention's non-causal prefill,
               # a decode step's self-attention over up to 782 keys
               # (ragged) and its cross-attention over all 1,500 keys; then
               # non-causal calls over 1,500 keys with ragged kv_len
               (2, 1500, 1500, 20, 20, 64, False, None, PREFILL),
               (2, 750, 750, 20, 20, 64, True, None, PREFILL),
               (2, 750, 1500, 20, 20, 64, False, None, PREFILL),
               (8, 1, 782, 20, 20, 64, True,
                [751, 782, 760, 1, 64, 65, 400, 781], DECODE),
               (8, 1, 1500, 20, 20, 64, False, None, DECODE),
               (3, 750, 1500, 20, 20, 64, False, [1500, 1000, 65], PREFILL),
               (4, 1, 1500, 20, 20, 64, False, [1, 1500, 1499, 700], DECODE)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq", [8, 2048])
def test_flash_attention_mla_prefill_head_dim_192(cuda, tq, dtype, tol):
    """deepseek-v2-lite's MLA prefill shape (batch 8, 16 heads, rep 1,
    head_dim 192 with v's last 64 columns zero, scale 192 ** -0.5): the
    kernel against its plain version; 2048 tokens take ``mma`` in bf16 and
    ``simt`` in f32, an 8-token prompt ``split``. The padded columns stay
    zero."""
    b, h, d = 8, 16, 192
    g = torch.Generator(cuda).manual_seed(tq)
    q, k, v = (torch.randn((b, tq, h, d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    v[..., 128:] = 0
    body = fa.plan(b, tq, tq, h, h, d, dtype).body
    assert body == ("split" if tq == 8 else
                    "mma" if dtype == torch.bfloat16 else "simt")
    fa.reset_launches()
    got = fa.attention(q, k, v, causal=True, scale=d ** -0.5)
    want = fa.attention_plain(q, k, v, causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
    assert ((got.float() - want.float()).abs()
            <= tol * (want.float().abs() + rms)).all()
    assert (got[..., 128:] == 0).all()
    assert fa.launches["flash_attention"] == 1
    assert fa.launches[f"flash_attention_{body}"] == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype, tol):
    b, tq, tkv, hq, hkv, d, causal, kv_len, bodies = case
    body = bodies[dtype == torch.bfloat16]
    g = torch.Generator(cuda).manual_seed(tq)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, tq, hq, d), (b, tkv, hkv, d), (b, tkv, hkv, d)))
    fa.reset_launches()
    got = fa.attention(q, k, v, causal=causal, kv_len=kv_len)
    want = fa.attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.device.type == "cuda"
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # Per output row, scaled by |want| plus the row's RMS: a row averaging
    # over ~1000 keys (RMS ~ 0.03) fails this if a key tile goes missing.
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
    assert ((got.float() - want.float()).abs()
            <= tol * (want.float().abs() + rms)).all()
    expect = {k_: 0 for k_ in fa.launches}
    expect["flash_attention"] = expect[f"flash_attention_{body}"] = 1
    if body == "split":
        expect["flash_attention_combine"] = 1
    assert fa.launches == expect


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_golden_at_full_width(cuda, arch):
    """The JAX package's f32 golden (``tests/fixtures``; mamba2-130m at full
    depth, zamba2-7b at depth 7 with one shared-block application): the
    numpy recipe's weights in f32 on the card, TF32 off, a prefill of 2 x
    300 tokens and 3 teacher-forced decode steps; the logits at the
    golden's top-32 indices and the logsumexp within 1e-4."""
    import dataclasses
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
    from repro_torch.models import lm

    g = np.load(Path(__file__).parent / "fixtures"
                / f"{arch.replace('-', '_')}_golden.npz")
    cfg = dataclasses.replace(get_config(arch), num_layers=int(g["layers"]),
                              dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = lm_params_from_numpy(cfg, numpy_lm_params(cfg, int(g["seed"])),
                                     device=cuda)
        tokens = torch.from_numpy(g["tokens"]).to(cuda)
        p = int(g["prompt_len"])
        cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                              device=cuda)
        fa.reset_launches()
        logits, cache = lm.prefill(model, cfg, tokens=tokens[:, :p],
                                   cache=cache)
        steps = [logits]
        for i in range(p, tokens.shape[1]):
            logits, cache = lm.decode_step(model, cfg, tokens[:, i], cache, i)
            steps.append(logits)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lg = torch.stack(steps).cpu().numpy()
    k = int(g["topk"])
    at = np.take_along_axis(lg, g["top_idx"][..., :k], -1)
    np.testing.assert_allclose(at, g["top_val"][..., :k], rtol=1e-4, atol=1e-4)
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse, g["lse"], rtol=1e-4, atol=1e-4)
    # zamba2's shared block: the prefill on simt (f32), each step split
    apps = 1 if arch == "zamba2-7b" else 0
    assert fa.launches["flash_attention"] == 4 * apps
    assert fa.launches["flash_attention_simt"] == apps


def test_whisper_golden_at_full_width(cuda):
    """The JAX package's f32 golden of whisper-large-v3 at full width and
    depth (``tests/fixtures/whisper_large_v3_golden.npz``): the numpy
    recipe's weights in f32 on the card (~6.1 GB), TF32 off, the encoder
    over 2 x 150 frames, a prefill of 75 tokens and 3 teacher-forced decode
    steps; the logits at the golden's top-32 indices and the logsumexp
    within 1e-4; the f32 prefill's 96 calls on ``simt``, the steps' on
    ``split``."""
    import dataclasses
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
    from repro_torch.models import lm

    g = np.load(Path(__file__).parent / "fixtures"
                / "whisper_large_v3_golden.npz")
    cfg = dataclasses.replace(get_config("whisper-large-v3"), dtype="float32")
    rng = np.random.default_rng(int(g["seed"]))
    frames = rng.standard_normal(
        (g["tokens"].shape[0], int(g["frames_len"]), cfg.d_model),
        dtype=np.float32)
    assert frames.sum(dtype=np.float64) == float(g["frames_sum"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = lm_params_from_numpy(cfg, numpy_lm_params(cfg, int(g["seed"])),
                                     device=cuda)
        tokens = torch.from_numpy(g["tokens"]).to(cuda)
        frames = torch.from_numpy(frames).to(cuda)
        p = int(g["prompt_len"])
        cache = lm.encdec_init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                     frames.shape[1], device=cuda)
        fa.reset_launches()
        logits, cache = lm.prefill_encdec(model, cfg, frames, tokens[:, :p],
                                          cache)
        steps = [logits]
        for i in range(p, tokens.shape[1]):
            logits, cache = lm.decode_step_encdec(model, cfg, tokens[:, i],
                                                  cache, i)
            steps.append(logits)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lg = torch.stack(steps).cpu().numpy()
    k = int(g["topk"])
    at = np.take_along_axis(lg, g["top_idx"][..., :k], -1)
    np.testing.assert_allclose(at, g["top_val"][..., :k], rtol=1e-4, atol=1e-4)
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse, g["lse"], rtol=1e-4, atol=1e-4)
    assert fa.launches["flash_attention_simt"] == 96
    assert fa.launches["flash_attention_split"] == 64 * (len(steps) - 1)


def test_partitionable_draws_on_the_card_equal_the_cpu(cuda):
    """Sampled decoding's draws: the partitionable layout's bits and
    uniforms from keys on the card equal the CPU's bit for bit, and a
    sampled token on the card equals the CPU's argmax of the same logits
    plus the CPU's Gumbel noise."""
    from repro_torch.core import prng
    from repro_torch.train import steps

    shape = (8, 151936)
    for seed in (0, 11, 2**31 - 1):
        key = prng.key(seed)
        for draw in (lambda k: prng.random_bits(k, 32, shape,
                                                partitionable=True),
                     lambda k: prng.random_bits(k, 64, (5, 7),
                                                partitionable=True),
                     lambda k: prng.uniform(k, shape, prng.F32_TINY, 1.0
                                            ).view(torch.int32)):
            assert torch.equal(draw(key.to(cuda)).cpu(), draw(key))
        logits = torch.randn(shape, generator=torch.Generator().manual_seed(
            seed)) * 3
        got = steps.sample(key.to(cuda), logits.to(cuda), 0.8)
        want = torch.argmax(prng.gumbel(key, shape) + logits / 0.8,
                            -1).to(torch.int32)
        assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# The tensor and select engines' chunks, replayed from captured CUDA graphs.
# ---------------------------------------------------------------------------

def _engine_case(cuda, engine, policy, eject):
    """(graph, the eager chunk of K cycles with its done trace, start
    states): cycle 0, mid-run, 3 cycles before the end (made by the
    megakernel engine, which gives the same bits) and the mid-run state
    with -0.0 for every zero of its float planes. ``policy="batch"`` is the
    mixed batch of ``_mixed_batch``."""
    from repro_torch.core import overlay, schedulers

    cap, pol = EJECTS[eject]
    batched = policy == "batch"
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy in ("ooo", "batch"))
    g = device_graph(gm, device=cuda)
    if batched:
        base, cfgs, s0 = _mixed_batch(g, cap, pol)
        budgets = [c.max_cycles for c in cfgs]
        ends = overlay.run_batch_state(g, base, BATCH_POLICIES, _clone(s0),
                                       budgets)["cycle"].tolist()
        late = overlay.run_batch_state(
            g, base, BATCH_POLICIES, _clone(s0),
            [min(m, e - 3) for m, e in zip(budgets, ends)])
        cfg = OverlayConfig(scheduler=base.scheduler, eject_capacity=cap,
                            eject_policy=pol, engine=engine)
        cycle = overlay.make_cycle_fn(
            g, cfg, scheduler=schedulers.BatchedScheduler(BATCH_POLICIES))
        make = lambda k: overlay.make_batch_chunk_fn(cycle, k, with_trace=True)
    else:
        mega = OverlayConfig(scheduler=policy, eject_capacity=cap,
                             eject_policy=pol, engine="megakernel")
        s0 = init_state(g, mega)
        end = int(run_state(g, mega, _clone(s0))["cycle"])
        late = run_state(g, OverlayConfig(
            scheduler=policy, eject_capacity=cap, eject_policy=pol,
            engine="megakernel", max_cycles=end - 3), _clone(s0))
        cfg = OverlayConfig(scheduler=policy, eject_capacity=cap,
                            eject_policy=pol, engine=engine)
        cycle = overlay.make_cycle_fn(g, cfg)
        make = lambda k: overlay.make_chunk_fn(cycle, k, with_trace=True)
    mid, _ = make(40)(_clone(s0))
    zeros = _clone(mid)
    for leaf in ("operands", "value"):
        zeros[leaf] = torch.where(zeros[leaf] == 0,
                                  torch.full_like(zeros[leaf], -0.0),
                                  zeros[leaf])
    return g, cfg, make, {"cycle 0": s0, "mid-run": mid, "late": late,
                          "signed zeros": zeros}


@pytest.mark.parametrize("engine", ("tensor", "select"))
@pytest.mark.parametrize("policy", (*sorted(GOLDENS), "batch"))
def test_eager_chunk_makes_no_host_sync(cuda, engine, policy):
    """The eager chunk, solo and batched, runs under
    ``set_sync_debug_mode("error")``: no op of the cycle waits on the card,
    which a capture would refuse."""
    _, _, make, states = _engine_case(cuda, engine, policy, "n_first_cap1")
    chunk, s = make(7), _clone(states["mid-run"])
    chunk(_clone(s))        # kernels built and loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("eject", sorted(EJECTS))
@pytest.mark.parametrize("policy", (*sorted(GOLDENS), "batch"))
@pytest.mark.parametrize("engine", ("tensor", "select"))
def test_replayed_chunk_equals_the_eager_chunk(cuda, engine, policy, eject):
    """The replayed chunk against the eager one on clones of four states,
    at K = 7 and the engine's own K (16), every leaf and the done trace as
    bit patterns; the replayed chunk returns the tensors of the state it
    captured."""
    from repro_torch.core import overlay

    _, _, make, states = _engine_case(cuda, engine, policy, eject)
    for k in (7, 16):
        for name, st in states.items():
            want, want_trace = make(k)(_clone(st))
            s = _clone(st)
            replayed = overlay.ReplayedChunk(make(k), f"{engine} {policy}")
            got, got_trace = replayed(s)
            torch.cuda.synchronize()
            assert got is s, name
            _assert_bits_equal(got, want)
            assert torch.equal(got_trace, want_trace), (name, k)
            # A second replay is the eager chunk applied twice.
            want2, want2_trace = make(k)(_clone(want))
            got2, got2_trace = replayed(got)
            torch.cuda.synchronize()
            _assert_bits_equal(got2, want2)
            assert torch.equal(got2_trace, want2_trace), (name, k)


def test_replayed_chunk_copies_a_foreign_state_in(cuda):
    """A call with a state whose leaves are other tensors than the captured
    ones copies them into the captured tensors first: the result is the
    chunk of the new state, in the captured tensors; the state passed in is
    left as it was."""
    from repro_torch.core import overlay

    _, _, make, states = _engine_case(cuda, "select", "ooo", "n_first_cap1")
    replayed = overlay.ReplayedChunk(make(16), "select ooo")
    captured = _clone(states["cycle 0"])
    replayed(captured)
    foreign = _clone(states["late"])
    kept = _clone(foreign)
    want, want_trace = make(16)(_clone(foreign))
    got, got_trace = replayed(foreign)
    torch.cuda.synchronize()
    assert got is captured
    _assert_bits_equal(got, want)
    assert torch.equal(got_trace, want_trace)
    _assert_bits_equal(foreign, kept)
    assert replayed.replays == 2


@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_select_goldens_count_replayed_launches(cuda, policy, monkeypatch):
    """``repro_torch.run`` under ``select`` and ``tensor`` replays its
    chunks (the run ends within a chunk, so no cycle runs eagerly): the
    goldens hold, and each leading-one kernel's count is the replays times
    the launches the capture recorded, non-zero for the policies that pick
    through one."""
    from repro_torch.core import overlay

    made = []

    class Spy(overlay.ReplayedChunk):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(overlay, "ReplayedChunk", Spy)
    g = wl.arrow_lu_graph(3, 6, 4, seed=5)
    for engine in ("select", "tensor"):
        made.clear()
        lod.reset_launches()
        r = repro_torch.run(g, OverlayConfig(scheduler=policy, engine=engine),
                            nx=2, ny=2)
        assert r.done and (r.cycles, r.deflections) == GOLDENS[policy]
        assert len(made) == 1 and made[0].replays == -(-r.cycles // 16)
        want = {k: made[0].replays * made[0].per_replay.get(k, 0)
                for k in lod.launches}
        assert lod.launches == want
        kernel = KERNEL_OF.get(policy)
        assert (engine == "select" and kernel is not None) == any(
            want.values())
        if engine == "select" and kernel is not None:
            assert made[0].per_replay == {kernel: 16}


def test_capture_failure_raises(cuda):
    """A chunk that cannot be captured raises, naming the chunk: a Python
    error during the capture, and an op that waits on the card (refused by
    the capture); the card works on after both."""
    from repro_torch.core import overlay

    _, _, make, states = _engine_case(cuda, "select", "ooo", "n_first_cap1")
    chunk = make(7)

    def breaks_in_capture(s):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("not capturable")
        return chunk(s)

    with pytest.raises(RuntimeError, match="capturing the broken chunk"):
        overlay.ReplayedChunk(breaks_in_capture, "broken")(
            _clone(states["mid-run"]))

    def syncs(s):
        out = chunk(s)
        out[0]["cycle"].item()
        return out

    with pytest.raises(RuntimeError, match="capturing the syncing chunk"):
        overlay.ReplayedChunk(syncs, "syncing")(_clone(states["mid-run"]))
    torch.cuda.synchronize()
    assert torch.ones(4, device=cuda).sum().item() == 4.0


# ---------------------------------------------------------------------------
# Telemetry: the traced megakernel and the traced replayed chunks.
# ---------------------------------------------------------------------------

#: 16 buckets of 8 cycles: the matrix graph's runs clamp into the last one.
TRACE_SPEC = dict(buckets=16, bucket_cycles=8)


def _traced(policy, eject, engine, **kw):
    from repro_torch.telemetry import TelemetrySpec

    cap, pol = EJECTS[eject]
    return OverlayConfig(scheduler=policy, eject_capacity=cap,
                         eject_policy=pol, engine=engine,
                         telemetry=TelemetrySpec(**TRACE_SPEC), **kw)


@pytest.mark.parametrize("eject", sorted(EJECTS))
@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_traced_megakernel_matches_plain_chunk(cuda, policy, eject):
    """The traced kernel's chunk equals the traced plain chunk bit for bit,
    every state leaf and trace leaf, from cycle 0, mid-run and near the end,
    at K = 1, 7 and 32, on both bodies; one traced launch each."""
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy == "ooo")
    g = device_graph(gm, device=cuda)
    cfg = _traced(policy, eject, "megakernel")
    s0 = init_state(g, cfg)
    end = int(run_state(g, cfg, _clone(s0))["cycle"])
    late = run_state(g, _traced(policy, eject, "megakernel",
                                max_cycles=end - 3), _clone(s0))
    mid = megakernel.mega_chunk_plain(g, cfg, 40)(_clone(s0))
    for state in (s0, mid, late):
        for k in (1, 7, 32):
            want, want_trace = megakernel.mega_chunk_plain(
                g, cfg, k, with_trace=True)(_clone(state))
            for body in ("shared", "global"):
                megakernel.reset_launches()
                got, got_trace = megakernel.make_mega_chunk_fn(
                    g, cfg, k, with_trace=True, body=body)(_clone(state))
                torch.cuda.synchronize()
                assert megakernel.launches["mega_chunk_traced"] == 1
                _assert_bits_equal(got, want)
                assert torch.equal(got_trace, want_trace)


@pytest.mark.parametrize("engine", ("tensor", "select", "megakernel"))
@pytest.mark.parametrize("policy", sorted(GOLDENS))
def test_traced_engines_equal_the_cpu(cuda, engine, policy):
    """A traced run on the card (replayed chunks or the traced kernel)
    gives the CPU run's results and traces bit for bit."""
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=policy == "ooo")
    cfg = _traced(policy, "n_first_cap1", engine)
    got = repro_torch.run(gm, cfg)
    want = repro_torch.run(gm, cfg, device="cpu")
    assert (got.cycles, got.deflections) == GOLDENS[policy]
    assert got.telemetry.traces.keys() == want.telemetry.traces.keys()
    for k, v in want.telemetry.traces.items():
        np.testing.assert_array_equal(got.telemetry.traces[k], v, err_msg=k)


@pytest.mark.parametrize("engine", ("tensor", "select"))
def test_traced_eager_chunk_makes_no_host_sync(cuda, engine):
    """The traced cycle reads nothing on the host (the bucket index stays
    on the card), so its chunk can be captured."""
    from repro_torch.core import overlay

    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2)
    g = device_graph(gm, device=cuda)
    cfg = _traced("ooo", "n_first_cap1", engine)
    chunk = overlay.make_chunk_fn(overlay.make_cycle_fn(g, cfg), 7)
    s = chunk(init_state(g, cfg))    # kernels built and loaded first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The placement annealer's kernel (kernels/csrc/anneal.cu).
# ---------------------------------------------------------------------------

ANNEAL_CASES = [((2, 4, 3), (2, 2), 1, 2, 0), ((2, 4, 3), (4, 4), 2, 3, 5),
                ((2, 4, 3), (4, 4), 3, 1, 1), ((2, 8, 6), (8, 8), 8, 2, 2),
                ((2, 8, 6), (8, 8), 40, 2, 4)]


@pytest.mark.parametrize("args,grid,replicas,rounds,seed", ANNEAL_CASES)
def test_anneal_kernel_equals_plain(cuda, args, grid, replicas, rounds, seed):
    """Best placements, best costs and the init cost equal the plain
    annealer's as integers; more than 32 replicas share warps."""
    from repro_torch.kernels import anneal as ka
    from repro_torch.place import anneal as pa
    from repro_torch.place.spec import AnnealConfig

    g = wl.arrow_lu_graph(*args, seed=3)
    acfg = AnnealConfig(replicas=replicas, rounds=rounds, steps=24,
                        seed=seed, t_max=200.0)
    before = ka.launches["anneal"]
    got = pa.anneal_placement(g, *grid, acfg)
    assert ka.launches["anneal"] == before + 1
    want = pa.anneal_placement(g, *grid, acfg, device="cpu")
    np.testing.assert_array_equal(got.node_pe, want.node_pe)
    np.testing.assert_array_equal(got.replica_costs, want.replica_costs)
    assert got.init_cost == want.init_cost


def test_anneal_kernel_many_ladders_and_bench_cost(cuda):
    """One launch runs every ladder of ``anneal_placements``; the BENCH
    n3689 search reaches the reference's cost 1,045,048."""
    from repro_torch.kernels import anneal as ka
    from repro_torch.place import anneal as pa
    from repro_torch.place.spec import AnnealConfig

    g = wl.arrow_lu_graph(2, 8, 6, seed=3)
    acfgs = [AnnealConfig(replicas=8, rounds=2, steps=32, seed=s, t_max=t)
             for s, t in ((0, 64.0), (1, 4.0), (2, 400.0))]
    before = ka.launches["anneal"]
    got = pa.anneal_placements(g, 8, 8, acfgs)
    assert ka.launches["anneal"] == before + 1
    for r, acfg in zip(got, acfgs):
        want = pa.anneal_placement(g, 8, 8, acfg, device="cpu")
        np.testing.assert_array_equal(r.node_pe, want.node_pe)
        np.testing.assert_array_equal(r.replica_costs, want.replica_costs)
    r = pa.anneal_placement(g, 8, 8, AnnealConfig(replicas=8, rounds=32,
                                                  steps=1024, seed=0))
    assert (r.init_cost, r.cost) == (1_104_696, 1_045_048)


# ---------------------------------------------------------------------------
# The guided search: the anneal kernel's GUIDED instantiation, the surrogate.
# ---------------------------------------------------------------------------

#: (arrow_lu_graph args, grid, replicas, rounds, margin, guide_every)
GUIDED_CASES = [((2, 4, 3), (2, 2), 1, 2, 0.0, 1),
                ((2, 4, 3), (4, 2), 2, 1, float("inf"), 3),
                ((2, 8, 6), (8, 8), 8, 2, -2.5, 1),
                ((2, 8, 6), (8, 8), 8, 2, 0.0, 3)]


def _slopes_guide(g, grid, seed):
    from repro_torch import surrogate
    from repro_torch.surrogate.delta import Guide

    rng = np.random.default_rng(seed)
    return Guide(extractor=surrogate.build_features(g, *grid),
                 gamma_q=rng.integers(-(1 << 20), 1 << 20, 29).astype(np.int64))


@pytest.mark.parametrize("args,grid,replicas,rounds,margin,every",
                         GUIDED_CASES)
def test_guided_kernel_equals_plain(cuda, args, grid, replicas, rounds,
                                    margin, every):
    """The guided search on the card (one launch of the GUIDED kernel)
    equals the plain guided search on the CPU: placements, per-replica
    costs, the init cost and the cost evaluations; at an open gate it also
    equals the unguided kernel."""
    from repro_torch.kernels import anneal as ka
    from repro_torch.place import anneal as pa
    from repro_torch.place.spec import AnnealConfig

    g = wl.arrow_lu_graph(*args, seed=3)
    guide = _slopes_guide(g, grid, 1)
    acfg = AnnealConfig(replicas=replicas, rounds=rounds, steps=24, seed=2,
                        t_max=200.0)
    knobs = dict(guide=guide, guide_margin=margin, guide_every=every)
    before = ka.launches["anneal_guided"]
    got = pa.anneal_placement(g, *grid, acfg, **knobs)
    assert ka.launches["anneal_guided"] == before + 1
    want = pa.anneal_placement(g, *grid, acfg, device="cpu", **knobs)
    np.testing.assert_array_equal(got.node_pe, want.node_pe)
    np.testing.assert_array_equal(got.replica_costs, want.replica_costs)
    assert (got.init_cost, got.cost_evals) == (want.init_cost,
                                               want.cost_evals)
    if margin == float("inf"):
        plain = pa.anneal_placement(g, *grid, acfg)
        np.testing.assert_array_equal(got.node_pe, plain.node_pe)
        assert got.cost_evals == got.proposals


def test_surrogate_features_on_the_card_equal_the_cpu(cuda):
    """Integer features are exact in any order: the card's matrix is the
    CPU's bit for bit, and so is the multilevel guided search."""
    from repro_torch import place, surrogate

    g = wl.arrow_lu_graph(2, 8, 6, seed=3)
    cands = surrogate.sample_placements(g, 8, 8, 16, seed=3)
    ex = surrogate.build_features(g, 8, 8)
    np.testing.assert_array_equal(ex.features_batch(cands),
                                  ex.features_batch(cands, device="cpu"))
    guide = _slopes_guide(g, (8, 8), 2)
    acfg = place.AnnealConfig(replicas=4, rounds=2, steps=32, seed=1)
    a = place.multilevel_anneal(g, 8, 8, acfg, ratio=8, guide=guide)
    b = place.multilevel_anneal(g, 8, 8, acfg, ratio=8, guide=guide,
                                device="cpu")
    np.testing.assert_array_equal(a.node_pe, b.node_pe)
    assert (a.coarse.cost_evals, a.refined.cost_evals) == (
        b.coarse.cost_evals, b.refined.cost_evals)


def test_one_by_one_nccl_mesh_equals_the_non_mesh_run(cuda, tmp_path):
    """``run(..., mesh=)`` on a 1x1 mesh over NCCL (a world of one, a
    FileStore rendezvous) under ``megakernel``, solo and batched: every
    result equals the non-mesh run leaf for leaf, through the solo and the
    batched kernel, with no collective launched."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed

    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), 2, 2,
                            criticality_order=True)
    cfg = OverlayConfig(engine="megakernel")
    cfgs = [OverlayConfig(scheduler=p, engine="megakernel")
            for p in ("ooo", "inorder")] + [
        OverlayConfig(scheduler="scan", max_cycles=200, engine="megakernel")]
    want, want_batch = repro_torch.run(gm, cfg), repro_torch.run(gm, batch=cfgs)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        megakernel.reset_launches()
        distributed.reset_stats()
        got = repro_torch.run(gm, cfg, mesh=mesh)
        got_batch = repro_torch.run(gm, mesh=mesh, batch=cfgs)
        launches, stats = dict(megakernel.launches), dict(distributed.stats)
    finally:
        dist.destroy_process_group()
    assert launches["mega_chunk"] > 0 and launches["mega_chunk_batched"] > 0
    assert stats == dict(halo=0, all_reduce=0, all_gather=0, halo_s=0.0)
    assert (got.cycles, got.deflections) == GOLDENS["ooo"]
    for a, b in zip([got, *got_batch], [want, *want_batch]):
        for f in ("cycles", "done", "delivered", "deflections", "busy_cycles",
                  "noc_deflections", "eject_deflections"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.values.view(np.int32),
                                      b.values.view(np.int32))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_training_on_the_card_launches_no_attention_kernel(cuda):
    """The driver at full width (qwen2-0.5b, bf16 with f32 master weights,
    a short zipf run): finite losses that fall, kernel 5 launched 0 times
    (training takes the differentiable form); then a serve prefill of the
    trained model launches it (the dispatch goes back to the kernel under
    ``no_grad``)."""
    from repro_torch.launch import train
    from repro_torch.models import lm

    losses = []
    fa.reset_launches()
    state = train.main(["--arch", "qwen2-0.5b", "--data", "zipf", "--batch",
                        "2", "--seq", "256", "--steps", "8", "--warmup", "2",
                        "--log-every", "100"],
                       on_step=lambda s, st, m: losses.append(m["loss"].item()))
    assert fa.launches["flash_attention"] == 0
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(
        losses[:3])
    model, cfg = state["params"], state["params"].cfg
    cache = lm.init_cache(cfg, 1, 16, device=cuda)
    lm.prefill(model, cfg, tokens=torch.zeros(1, 16, dtype=torch.int32,
                                              device=cuda), cache=cache)
    assert fa.launches["flash_attention"] == cfg.num_layers


def test_train_golden_and_accumulation_at_depth_2_on_the_card(cuda):
    """``chip_smoke.py`` phase 20b's checks at the golden's depth 2 (f32,
    TF32 off): the JAX package's training golden, then ``grad_accum=2``
    against the full batch."""
    cs = _chip_smoke()
    g = np.load(cs.TRAIN_GOLDEN)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err, tree = cs.train_golden(torch, np, "cuda", g, "small_")
        cs.train_accum(torch, np, "cuda", tree, int(g["small_layers"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert set(err) >= {"loss", "grad", "new"}


def test_every_family_trains_on_the_card_as_on_the_cpu(cuda):
    """``chip_smoke.py`` phase 20c: one train step of every registry arch's
    smoke config on the card against the CPU."""
    cs = _chip_smoke()
    out = cs.train_families(torch, np, fa)
    from repro_torch.configs import ARCHS
    assert set(out) == set(ARCHS)


def test_the_driver_resumes_a_crashed_run_on_the_card(cuda):
    """``chip_smoke.py`` phase 20c: ``--sim-fail``, the restored state equal
    to the saved one and the resumed run to the uninterrupted one, bit for
    bit."""
    assert _chip_smoke().train_resume(torch, np) == 0
