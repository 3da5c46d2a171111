"""One megakernel chunk handed over from the reference, leaf for leaf.

The reference runs the matrix graph cycle by cycle to cycle 17, dumps its
state, applies one chunk of its Pallas megakernel (``make_engine_chunk_fn``
with ``engine="megakernel"``, 32 cycles, interpret mode) and dumps the
result. The port converts the cycle-17 state, applies its own
``make_mega_chunk_fn`` (the plain version, on the CPU) and must reach the
same state: every leaf equal, float leaves as bit patterns. A state a few
cycles before completion on ``layered_dag`` pins the chunk repair of
``cycle`` and ``done``.
"""
import numpy as np
import pytest

from _torch_ref import (EJECTS, MATRIX_GRAPH, assert_tree_equal,
                        run_reference, unflatten)
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import overlay
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import megakernel

K = 32
#: (name, graph, policy, eject, hand-over cycle). The matrix graph runs
#: ~1,400 cycles; layered_dag completes at cycle 24 (ooo) and 27 (scan),
#: inside the chunk that starts at 20 and 22.
CASES = [
    ("ooo", "arrow", "ooo", "n_first_cap1", 17),
    ("inorder", "arrow", "inorder", "priority_cap1", 17),
    ("lru_flat", "arrow", "lru_flat", "cap2", 17),
    ("ooo_completes", "layered", "ooo", "n_first_cap1", 20),
    ("scan_completes", "layered", "scan", "n_first_cap1", 22),
]


def _graph(name):
    if name == "arrow":
        b, s, w, seed = MATRIX_GRAPH
        return wl.arrow_lu_graph(b, s, w, seed=seed)
    return wl.layered_dag(4, 6, seed=3)


def _cfg(policy, eject, **kw):
    cap, pol = EJECTS[eject]
    return OverlayConfig(scheduler=policy, eject_capacity=cap,
                         eject_policy=pol, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import jax
    from repro.core import workloads as wl
    from repro.core.overlay import (OverlayConfig, _run_jit, device_graph,
                                    make_engine_chunk_fn)
    from repro.core.partition import build_graph_memory

    b, s, w, seed = {MATRIX_GRAPH!r}
    graphs = dict(arrow=wl.arrow_lu_graph(b, s, w, seed=seed),
                  layered=wl.layered_dag(4, 6, seed=3))
    ejects = {EJECTS!r}
    for name, graph, pol, eject, start in {CASES!r}:
        cap, ep = ejects[eject]
        gm = build_graph_memory(graphs[graph], 2, 2,
                                criticality_order=pol == "ooo")
        g = dict(device_graph(gm))
        cfg = OverlayConfig(scheduler=pol, eject_capacity=cap,
                            eject_policy=ep, check_every=1, max_cycles=start)
        st = _run_jit(g, cfg, gm.nx, gm.ny)
        res.update(flatten(st, f"{{name}}/start"))
        mega = OverlayConfig(scheduler=pol, eject_capacity=cap,
                             eject_policy=ep, engine="megakernel")
        chunk = jax.jit(make_engine_chunk_fn(g, mega, {K}))
        res.update(flatten(chunk(st), f"{{name}}/end"))
    """
    return run_reference(tmp_path_factory, "megakernel_handover", body)


def _float_bits(tree):
    """Float leaves as their int32 bit patterns (-0.0 differs from +0.0)."""
    return {k: _float_bits(v) if isinstance(v, dict)
            else v.view(np.int32) if v.dtype == np.float32 else v
            for k, v in tree.items()}


@pytest.mark.parametrize("name,graph,policy,eject,start", CASES,
                         ids=[c[0] for c in CASES])
def test_chunk_handed_over_matches_reference(reference, name, graph, policy,
                                             eject, start):
    gm = build_graph_memory(_graph(graph), 2, 2,
                            criticality_order=policy == "ooo")
    g = overlay.device_graph(gm, device="cpu")
    state = state_from_numpy(unflatten(reference, f"{name}/start"),
                             device="cpu")
    assert int(state["cycle"]) == start
    chunk = megakernel.make_mega_chunk_fn(
        g, _cfg(policy, eject, engine="megakernel"), K)
    got = state_to_numpy(chunk(state))
    want = unflatten(reference, f"{name}/end")
    assert_tree_equal(got, want)
    assert_tree_equal(_float_bits(got), _float_bits(want))
    if graph == "layered":
        assert bool(got["done"]) and int(got["cycle"]) < start + K
