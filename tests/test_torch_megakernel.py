"""The port's ``engine="megakernel"`` against the reference's: every policy x
chunk depth on ``layered_dag(4, 6, seed=3)`` (the reference's own megakernel
graph), cycle counts, stat counters and node values equal bit for bit; and
the engine's knobs, dispatch and leaf checks.

On the CPU the engine runs the kernel's plain version
(:func:`repro_torch.kernels.megakernel.mega_chunk_plain`); the reference
runs its Pallas megakernel in interpret mode. The CUDA kernel itself is held
against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import repro_torch
from _torch_ref import RESULT_KEYS, run_reference
from repro_torch.core import overlay
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import megakernel

POLICIES = ("inorder", "lru_flat", "ooo", "scan")
CHECK_EVERYS = (1, 8, 32)
#: Reference cycles/deflections on layered_dag(4, 6, seed=3), 2x2, each
#: policy on its own memory layout.
GOLDENS = {"ooo": (24, 5), "inorder": (26, 8), "lru_flat": (27, 6),
           "scan": (27, 6)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import repro
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory

    g = wl.layered_dag(4, 6, seed=3)
    for pol in {POLICIES!r}:
        gm = build_graph_memory(g, 2, 2, criticality_order=pol == "ooo")
        for K in {CHECK_EVERYS!r}:
            r = repro.run(gm, OverlayConfig(scheduler=pol, check_every=K,
                                            engine="megakernel"))
            for k, v in sim_result(r).items():
                res[f"{{pol}}/{{K}}/{{k}}"] = np.asarray(v)
    """
    return run_reference(tmp_path_factory, "megakernel", body)


def _graph():
    return wl.layered_dag(4, 6, seed=3)


@pytest.mark.parametrize("check_every", CHECK_EVERYS)
@pytest.mark.parametrize("policy", POLICIES)
def test_matches_reference_megakernel(reference, policy, check_every):
    r = repro_torch.run(_graph(), OverlayConfig(
        scheduler=policy, check_every=check_every, engine="megakernel"),
        nx=2, ny=2, device="cpu")
    for k in RESULT_KEYS:
        want = reference[f"{policy}/{check_every}/{k}"]
        got = getattr(r, k)
        if k == "values":
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        else:
            assert got == want.item(), (k, got, want)
    assert (r.cycles, r.deflections) == GOLDENS[policy]


def test_resolve_check_every():
    mega = OverlayConfig(engine="megakernel")
    for nx, ny, L in ((2, 2, 32), (16, 16, 64), (16, 16, 480)):
        for dev in ("cpu", "cuda"):
            assert overlay.resolve_check_every(mega, nx, ny, L,
                                               device_type=dev) == 32
    explicit = OverlayConfig(engine="megakernel", check_every=5)
    assert overlay.resolve_check_every(explicit, 16, 16, 64) == 5


def test_engine_accepted_and_unknown_engines_raise():
    assert OverlayConfig(engine="megakernel").engine == "megakernel"
    assert overlay.ENGINES == ("tensor", "select", "megakernel")
    assert OverlayConfig(engine="jnp").engine == "tensor"
    for bad in ("xla", "turbo"):
        with pytest.raises(ValueError, match="engine"):
            OverlayConfig(engine=bad)


def test_no_kernel_launch_on_cpu():
    megakernel.reset_launches()
    r = repro_torch.run(_graph(), OverlayConfig(engine="megakernel"),
                        nx=2, ny=2, device="cpu")
    assert r.done and (r.cycles, r.deflections) == GOLDENS["ooo"]
    assert megakernel.launches == {"mega_chunk": 0, "mega_chunk_batched": 0,
                                   "mega_chunk_shared": 0,
                                   "mega_chunk_global": 0,
                                   "mega_chunk_traced": 0}


def test_tail_runs_as_chunks_of_one(monkeypatch):
    """Full K-chunks while they fit ``max_cycles``, then chunks of one cycle
    through the same engine; the state equals the tensor engine's."""
    built = []
    make = megakernel.make_mega_chunk_fn

    def spy(g, cfg, check_every, **kw):
        built.append(check_every)
        return make(g, cfg, check_every, **kw)

    monkeypatch.setattr(megakernel, "make_mega_chunk_fn", spy)
    gm = build_graph_memory(_graph(), 2, 2)
    g = overlay.device_graph(gm, device="cpu")
    finals = {}
    for engine in ("megakernel", "tensor"):
        cfg = OverlayConfig(engine=engine, check_every=8, max_cycles=20)
        finals[engine] = overlay.run_state(g, cfg, overlay.init_state(g, cfg))
    assert built == [8, 1]
    for k, v in finals["tensor"].items():
        if k == "sched":
            for kk, vv in v.items():
                assert torch.equal(finals["megakernel"][k][kk], vv), kk
        else:
            assert torch.equal(finals["megakernel"][k], v), k
    assert int(finals["megakernel"]["cycle"]) == 20
    assert not bool(finals["megakernel"]["done"])


def test_done_trace_and_repair():
    """A chunk that completes inside: the trace turns on at the completion
    cycle and stays on; ``cycle`` is repaired to the completion cycle."""
    gm = build_graph_memory(_graph(), 2, 2)
    g = overlay.device_graph(gm, device="cpu")
    cfg = OverlayConfig(engine="megakernel", check_every=1, max_cycles=20)
    s = overlay.run_state(g, cfg, overlay.init_state(g, cfg))
    s, trace = megakernel.make_mega_chunk_fn(g, cfg, 8, with_trace=True)(s)
    golden = GOLDENS["ooo"][0]
    assert trace.dtype == torch.bool and trace.shape == (8,)
    assert trace.tolist() == [20 + k + 1 >= golden for k in range(8)]
    assert int(s["cycle"]) == golden and bool(s["done"])


def _leaf_cases():
    def dtype(s):
        s["pending"] = s["pending"].to(torch.int64)

    def strided(s):
        s["value"] = s["value"].transpose(0, 1)

    def shape(s):
        s["sched"]["rdy"] = s["sched"]["rdy"][..., :0]

    def missing(s):
        del s["busy_cycles"]

    def device(s):
        s["cursor"] = s["cursor"].to("meta")

    # case -> (how to break the state, what the error names)
    return {"dtype": (dtype, "int32 of shape"), "strided": (strided, "contiguous"),
            "shape": (shape, "of shape"), "missing": (missing, "expected keys"),
            "device": (device, "is on meta")}


@pytest.mark.parametrize("case", sorted(_leaf_cases()))
def test_leaf_check_raises_before_dispatch(case):
    gm = build_graph_memory(_graph(), 2, 2)
    g = overlay.device_graph(gm, device="cpu")
    cfg = OverlayConfig(engine="megakernel")
    s = overlay.init_state(g, cfg)
    breaks, match = _leaf_cases()[case]
    breaks(s)
    chunk = megakernel.make_mega_chunk_fn(g, cfg, 4)
    with pytest.raises(ValueError, match=match):
        chunk(s)
