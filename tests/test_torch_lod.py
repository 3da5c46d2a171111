"""The leading-one kernels' plain versions against the reference's oracles
(``repro.kernels.ref``) and Pallas kernels (``repro.kernels.ops``, interpret
mode on the CPU), exactly; the wrappers' CPU routing, input checks and launch
counters. The kernels themselves run only on a card: see
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import lod

# One compiled program per shape instead of one per primitive.
lod_ref = jax.jit(ref.lod_ref)
schedule_step_ref = jax.jit(ref.schedule_step_ref)
rotating_schedule_step_ref = jax.jit(ref.rotating_schedule_step_ref)

# The reference's kernel-test shapes, plus the main path's RDY shapes on the
# 16x16 grid (256 PE rows of 2, 4 and 15 words).
MAIN_PATH_SHAPES = [(256, 2), (256, 4), (256, 15)]
SHAPES = [(1, 1), (7, 3), (64, 1), (256, 13), (300, 40), (8, 128), (4, 2),
          (128, 40), (37, 5)] + MAIN_PATH_SHAPES


def _inputs(p, w, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(p, w), dtype=np.uint32)
    bits[rng.random((p, w)) < 0.5] = 0
    bits[rng.random((p, w)) < 0.1] |= np.uint32(0x80000000)
    bits[0] = 0                                   # empty row -> -1
    ptr = rng.integers(0, w * 32, size=p).astype(np.int32)
    edges = np.array([0, 31, 32, w * 32 - 1], np.int32) % (w * 32)
    ptr[:min(p, 4)] = edges[:min(p, 4)]
    gates = {"none": None, "on": np.ones(p, bool), "off": np.zeros(p, bool),
             "mixed": rng.random(p) < 0.5}
    return bits, ptr, gates


def _t(a):
    if a is None:
        return None
    a = a.view(np.int32) if a.dtype == np.uint32 else a
    return torch.from_numpy(a.copy())


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, want):
    """torch result (int32 storage) vs reference result (uint32 / int32)."""
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,w", SHAPES)
def test_plain_versions_match_reference_oracles(p, w):
    bits, ptr, gates = _inputs(p, w, seed=p * 1000 + w)
    _eq(lod.lod_plain(_t(bits)), lod_ref(_j(bits)))
    # Every gate pattern at the main path's shapes, a mixed gate elsewhere.
    if (p, w) not in MAIN_PATH_SHAPES:
        gates = {"mixed": gates["mixed"]}
    for gate in gates.values():
        for got, want in zip(lod.schedule_step_plain(_t(bits), _t(gate)),
                             schedule_step_ref(_j(bits), _j(gate))):
            _eq(got, want)
        for got, want in zip(
                lod.rotating_schedule_step_plain(_t(bits), _t(ptr), _t(gate)),
                rotating_schedule_step_ref(_j(bits), _j(ptr), _j(gate))):
            _eq(got, want)


@pytest.mark.parametrize("p,w", [(4, 2), (37, 5)])
def test_plain_versions_match_pallas_kernels(p, w):
    bits, ptr, gates = _inputs(p, w, seed=7 * p + w)
    gate = gates["mixed"]
    _eq(lod.lod_plain(_t(bits)), ops.lod(_j(bits)))
    for got, want in zip(lod.schedule_step_plain(_t(bits), _t(gate)),
                         ops.schedule_step(_j(bits), _j(gate))):
        _eq(got, want)
    for got, want in zip(
            lod.rotating_schedule_step_plain(_t(bits), _t(ptr), _t(gate)),
            ops.rotating_schedule_step(_j(bits), _j(ptr), _j(gate))):
        _eq(got, want)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    bits, ptr, gates = _inputs(256, 4, seed=1)
    gate = _t(gates["mixed"])
    lod.reset_launches()
    torch.testing.assert_close(lod.lod(_t(bits)), lod.lod_plain(_t(bits)),
                               rtol=0, atol=0)
    for got, want in zip(lod.schedule_step(_t(bits), gate),
                         lod.schedule_step_plain(_t(bits), gate)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(lod.rotating_schedule_step(_t(bits), _t(ptr), gate),
                         lod.rotating_schedule_step_plain(_t(bits), _t(ptr), gate)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert lod.launches == {"lod": 0, "schedule_step": 0,
                            "rotating_schedule_step": 0}


def test_wrappers_check_their_inputs():
    bits = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        lod.lod(bits.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        lod.lod(torch.zeros((2, 8), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="gate"):
        lod.schedule_step(bits, torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="ptr"):
        lod.rotating_schedule_step(bits, torch.zeros(7, dtype=torch.int32))


def test_drain_empties_every_row():
    bits, _, _ = _inputs(8, 4, seed=0)
    t = _t(bits)
    total = int(np.unpackbits(bits.view(np.uint8)).sum())
    for _ in range(total):
        _, t = lod.schedule_step(t)
    assert int(t.abs().sum()) == 0
    assert (lod.schedule_step(t)[0] == -1).all()
