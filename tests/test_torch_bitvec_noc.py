"""Port vs reference, in one process: the RDY bit vectors
(``repro_torch.core.bitvec``), the Hoplite router (``core.noc``) and every
scheduler hook (``core.schedulers``) must equal the reference's jnp
functions exactly on the same numpy inputs. None of these reference modules
needs the ``enable_x64`` alias, so they are imported here directly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bitvec as jbitvec
from repro.core import noc as jnoc
from repro.core import schedulers as jsched
from _torch_ref import assert_tree_equal
from repro_torch.core import bitvec, noc, schedulers
from repro_torch.convert import state_from_numpy, state_to_numpy


def _words(rng, shape):
    """uint32 words with empty rows, top-bit words and single low bits."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w[rng.random(shape) < 0.4] = 0
    w[rng.random(shape) < 0.15] |= np.uint32(0x80000000)
    w[rng.random(shape) < 0.1] = np.uint32(1)
    w.reshape(-1, shape[-1])[0] = 0
    return w


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (64, 2), (256, 15), (5, 4, 9)])
def test_bitvec_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    w = _words(rng, shape)
    jw = jnp.asarray(w)
    np.testing.assert_array_equal(_u32(bitvec.smear(_t(w))),
                                  np.asarray(jbitvec.smear(jw)))
    np.testing.assert_array_equal(bitvec.popcount(_t(w)).numpy(),
                                  np.asarray(jbitvec.popcount(jw)).astype(np.int32))
    np.testing.assert_array_equal(bitvec.lod_word(_t(w)).numpy(),
                                  np.asarray(jbitvec.lod_word(jw)))
    np.testing.assert_array_equal(bitvec.leading_one(_t(w)).numpy(),
                                  np.asarray(jbitvec.leading_one(jw)))
    np.testing.assert_array_equal(bitvec.count_set(_t(w)).numpy(),
                                  np.asarray(jbitvec.count_set(jw)))
    W = shape[-1]
    ptr = rng.integers(0, W * 32, size=shape[:-1]).astype(np.int32)
    edges = np.array([0, 31, 32, W * 32 - 1], np.int32) % (W * 32)
    ptr.reshape(-1)[:len(edges)] = edges[:ptr.size]
    np.testing.assert_array_equal(
        _u32(bitvec.mask_slots_ge(torch.from_numpy(ptr), W)),
        np.asarray(jbitvec.mask_slots_ge(jnp.asarray(ptr), W)))


def test_slot_word_mask_and_set_bit():
    rng = np.random.default_rng(3)
    p, W = 40, 3
    slot = rng.integers(0, W * 32, size=p).astype(np.int32)
    slot[:4] = [0, 31, 32, W * 32 - 1]
    word, mask = bitvec.slot_word_mask(torch.from_numpy(slot))
    jword, jmask = jbitvec.slot_word_mask(jnp.asarray(slot))
    np.testing.assert_array_equal(word.numpy(), np.asarray(jword))
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    bits = _words(rng, (p, W))
    pe = rng.permutation(p).astype(np.int32)
    on = rng.random(p) < 0.6
    got = bitvec.set_bit(_t(bits), torch.from_numpy(pe), torch.from_numpy(slot),
                         torch.from_numpy(on))
    want = jbitvec.set_bit(jnp.asarray(bits), jnp.asarray(pe), jnp.asarray(slot),
                           jnp.asarray(on))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def _packets(rng, nx, ny):
    return dict(
        valid=rng.random((nx, ny)) < 0.6,
        dst_x=rng.integers(0, nx, (nx, ny)).astype(np.int32),
        dst_y=rng.integers(0, ny, (nx, ny)).astype(np.int32),
        dst_slot=rng.integers(0, 64, (nx, ny)).astype(np.int32),
        opidx=rng.integers(0, 2, (nx, ny)).astype(np.int32),
        value=rng.standard_normal((nx, ny)).astype(np.float32))


def _pack(p):
    return noc.pack({k: torch.from_numpy(v) for k, v in p.items()})


def _assert_packet(got, want):
    got = noc.unpack(got)
    for k in noc.PKT_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("eject_capacity", [1, 2])
@pytest.mark.parametrize("eject_policy", ["n_first", "priority"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_cycle_matches_reference(eject_policy, eject_capacity, seed):
    rng = np.random.default_rng(seed)
    nx, ny = 4, 3
    link_e, link_s, inject = (_packets(rng, nx, ny) for _ in range(3))
    j = lambda p: {k: jnp.asarray(v) for k, v in p.items()}
    want = jnoc.router_cycle(j(link_e), j(link_s), j(inject),
                             eject_capacity=eject_capacity,
                             eject_policy=eject_policy)
    got = noc.router_cycle(_pack(link_e), _pack(link_s), _pack(inject),
                           eject_capacity=eject_capacity,
                           eject_policy=eject_policy)
    _assert_packet(got[0], want[0])
    _assert_packet(got[1], want[1])
    assert len(got[2]) == len(want[2]) == eject_capacity
    for g_ej, w_ej in zip(got[2], want[2]):
        _assert_packet(g_ej, w_ej)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for k in ("noc", "eject"):
        np.testing.assert_array_equal(got[4][k].numpy(), np.asarray(want[4][k]))
    assert bool(noc.links_empty(got[0], got[1])) == bool(
        jnoc.links_empty(want[0], want[1]))


def _toy_graph(rng, nx, ny, L):
    valid = rng.random((nx, ny, L)) < 0.8
    fanin = np.where(rng.random((nx, ny, L)) < 0.3, 0, 2).astype(np.int32)
    return dict(
        opcode=np.where(fanin == 0, 0, 1).astype(np.int32),
        fanin=np.where(valid, fanin, 0).astype(np.int32),
        valid=valid,
        fo_count=rng.integers(0, 3, (nx, ny, L)).astype(np.int32))


def _assert_state(got, want):
    assert_tree_equal(state_to_numpy(got), want)


@pytest.mark.parametrize("name", ["ooo", "inorder", "scan", "lru_flat"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_scheduler_hooks_match_reference(name, use_kernels):
    rng = np.random.default_rng(len(name))
    nx, ny, L = 3, 2, 64
    g = _toy_graph(rng, nx, ny, L)
    jpol, pol = jsched.get(name), schedulers.get(name)
    jst = jpol.init({k: jnp.asarray(v) for k, v in g.items()}, None)
    st = pol.init({k: torch.from_numpy(v) for k, v in g.items()}, None)
    _assert_state(st, jst)
    ix = np.broadcast_to(np.arange(nx)[:, None], (nx, ny)).astype(np.int32)
    iy = np.broadcast_to(np.arange(ny)[None, :], (nx, ny)).astype(np.int32)
    for step in range(12):
        # Mark a fresh slot ready on some PEs, as a fire does, then pick.
        slot = rng.integers(0, L, (nx, ny)).astype(np.int32)
        ready = rng.random((nx, ny)) < 0.5
        jst = jpol.on_ready(jst, jnp.asarray(ix), jnp.asarray(iy),
                            jnp.asarray(slot), jnp.asarray(ready))
        st = pol.on_ready(st, torch.from_numpy(slot), torch.from_numpy(ready))
        _assert_state(st, jst)
        idle = rng.random((nx, ny)) < 0.7
        gate = idle & (rng.random((nx, ny)) < 0.7)
        jc, jh = jpol.select(jst, jnp.asarray(idle))
        c, h = pol.select(st, torch.from_numpy(idle))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        jc, jh, jst = jpol.step(jst, jnp.asarray(idle), jnp.asarray(gate))
        c, h, st = pol.step(st, torch.from_numpy(idle), torch.from_numpy(gate),
                            use_kernels=use_kernels)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        _assert_state(st, jst)
        assert bool(pol.empty(st)) == bool(jpol.empty(jst))
        # commit alone, on a copy of the state
        sel = gate & np.asarray(jh)
        _assert_state(pol.commit(st, torch.from_numpy(sel), c),
                      jpol.commit(jst, jnp.asarray(sel), jc))


def test_state_conversion_round_trip():
    rng = np.random.default_rng(9)
    tree = dict(
        sched=dict(rdy=_words(rng, (2, 3, 4)),
                   ptr=rng.integers(0, 128, (2, 3)).astype(np.int32)),
        link_e={k: np.asarray(v) for k, v in _packets(rng, 2, 3).items()},
        link_s={k: np.asarray(v) for k, v in _packets(rng, 2, 3).items()},
        value=rng.standard_normal((2, 3, 128)).astype(np.float32),
        cycle=np.int32(17), done=np.bool_(False))
    st = state_from_numpy(tree, device="cpu")
    assert st["sched"]["rdy"].dtype == torch.int32
    assert st["link_e"].shape == (6, 2, 3)
    _assert_state(st, tree)
