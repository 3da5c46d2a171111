"""The port's Mamba2 (``repro_torch.models.ssm``) against the reference's
``repro.models.ssm`` on the CPU, in float32 (rtol = atol = 1e-5).

The same numpy inputs go through both. ``ssd_scan`` at t = 1, chunk - 1,
chunk and 2 chunk + 5 (padded to whole chunks), and with decays so large
that the segment sums above the diagonal overflow to inf (masked by a
select, so no NaN); the causal conv with and without a carried state; the
block's sequence form, its prefill cache (``ssm_prefill_cache``: the final
state and the conv tail) and decode steps from that cache, with the
reference's own weights (``ssm.init``) loaded into the port's module; the
float32 leaves in a bfloat16 model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import blocks as ref_blocks
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import blocks, ssm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-130m"
CHUNK = 16


def _scan_inputs(t, seed, big=False):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, t, h)).astype(np.float32)
    A = -np.exp(rng.uniform(0, 1, h)).astype(np.float32)
    if big:                 # dt * A down to ~ -500 a step
        dt = rng.uniform(1.0, 5.0, (b, t, h)).astype(np.float32)
        A = -np.exp(rng.uniform(3, 4.6, h)).astype(np.float32)
    B = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, 2 * CHUNK + 5])
def test_ssd_scan_matches_reference(t):
    args = _scan_inputs(t, seed=t)
    y, state = ref_ssm.ssd_scan(*map(jnp.asarray, args), CHUNK)
    ty, tstate = ssm.ssd_scan(*map(torch.from_numpy, args), CHUNK)
    assert ty.shape == y.shape and tstate.shape == state.shape
    assert ty.dtype == tstate.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(state), **TOL)


def test_ssd_scan_large_decays_overflow_without_nan():
    """dt * A of -50 to -500 a step: within a chunk the segment sums above
    the diagonal reach +inf under exp; the select keeps them out."""
    args = _scan_inputs(2 * CHUNK + 3, seed=7, big=True)
    a = torch.from_numpy(args[1][:, :CHUNK] * args[2])            # [b, q, h]
    cs = a.cumsum(1)
    assert torch.isinf(torch.exp(cs[:, 0] - cs[:, -1])).all()     # i < j
    L = ssm._segsum_exp(a)
    assert torch.isfinite(L).all() and (L.triu(1) == 0).all()
    y, state = ref_ssm.ssd_scan(*map(jnp.asarray, args), CHUNK)
    ty, tstate = ssm.ssd_scan(*map(torch.from_numpy, args), CHUNK)
    assert torch.isfinite(ty).all() and torch.isfinite(tstate).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(state), **TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "init_state"])
def test_conv1d_matches_reference(carried):
    rng = np.random.default_rng(3)
    b, t, c, k = 2, 9, 6, 4
    u = rng.standard_normal((b, t, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    init = rng.standard_normal((b, k - 1, c)).astype(np.float32) if carried \
        else None
    want = ref_ssm._conv1d(jnp.asarray(u), jnp.asarray(w), jnp.asarray(bias),
                           None if init is None else jnp.asarray(init))
    got = ssm._conv1d(torch.from_numpy(u), torch.from_numpy(w),
                      torch.from_numpy(bias),
                      None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _port(seed):
    cfg, rcfg = get_config(ARCH, smoke=True), ref_config(ARCH, smoke=True)
    params = ref_ssm.init(jax.random.key(seed), rcfg)
    mod = ssm.Mamba2(cfg, device="cpu")
    mod.load_state_dict({name: torch.from_numpy(np.array(leaf)) for name, leaf
                         in convert._flatten(jax.tree.map(np.asarray, params))},
                        strict=True)
    return cfg, rcfg, params, mod


@pytest.mark.parametrize("t", [CHUNK - 1, 2 * CHUNK + 5])
def test_apply_seq_matches_reference(t):
    cfg, rcfg, params, mod = _port(seed=1)
    x = np.random.default_rng(4).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    want = ref_ssm.apply_seq(params, rcfg, jnp.asarray(x))
    got, extras = mod(torch.from_numpy(x), {"mode": "train"})
    assert extras == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_and_decode_match_reference():
    """``ssm_prefill_cache`` after a prompt longer than a chunk and not a
    multiple of it, then decode steps from that cache (the port's updated
    in place), each against the reference's."""
    cfg, rcfg, params, mod = _port(seed=2)
    b, p, steps = 2, 2 * CHUNK + 5, 4
    x = np.random.default_rng(5).standard_normal(
        (b, p + steps, cfg.d_model)).astype(np.float32)
    cache = ref_blocks.ssm_prefill_cache(params, rcfg, jnp.asarray(x[:, :p]))
    entry = blocks.ssm_prefill_cache(mod, cfg, torch.from_numpy(x[:, :p]))
    for name in ("state", "conv"):
        assert entry[name].dtype == torch.float32
        np.testing.assert_allclose(entry[name].numpy(),
                                   np.asarray(cache[name]), **TOL)
    tcache = ssm.init_cache(cfg, b, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: tuple(v.shape) for k, v in ref_ssm.init_cache(rcfg, b).items()}
    out, extras = mod(torch.from_numpy(x[:, :p]),
                      {"mode": "prefill", "cache": tcache})
    assert extras["cache"] is tcache
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_ssm.apply_seq(params, rcfg,
                                                  jnp.asarray(x[:, :p]))),
        **TOL)
    for i in range(p, p + steps):
        want, cache = ref_ssm.apply_decode(params, rcfg,
                                           jnp.asarray(x[:, i:i + 1]), cache)
        got, extras = mod(torch.from_numpy(x[:, i:i + 1]),
                          {"mode": "decode", "cache": tcache})
        assert extras["cache"] is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(cache[name]), **TOL)


def test_prefill_shorter_than_the_conv_tail_raises():
    cfg, _, _, mod = _port(seed=3)
    x = torch.zeros(1, cfg.ssm.d_conv - 2, cfg.d_model)
    with pytest.raises(ValueError, match="d_conv - 1"):
        blocks.ssm_prefill_cache(mod, cfg, x)


def test_softplus_agrees_with_jax():
    """``logaddexp(x, 0)`` on both sides; their exp and log1p round
    differently, by up to two f32 ulps (2.5e-7 relative), over the range
    of ``dt + dt_bias`` and far past it (above 20 neither switches to x)."""
    x = np.linspace(-40, 60, 100001, dtype=np.float32)
    np.testing.assert_allclose(
        ssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.5e-7, atol=0)


def test_float32_leaves_in_a_bfloat16_model():
    """The recipe into a bf16 model: ``A_log``, ``D`` and ``dt_bias`` stay
    float32 and exact, as the reference keeps them; the rest rounds to
    bf16; the recipe's constants are the reference's init's."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    tree = convert.numpy_lm_params(cfg, seed=6)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    mod, want = model.blocks[1].mamba, tree["segments"][0]["mamba"]
    _, nheads, _ = ssm.dims(cfg)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(mod, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(mod, name).numpy(),
                                      want[name][1])
    assert mod.in_proj.w.dtype == mod.conv.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mod.conv.w.float().numpy(),
        torch.from_numpy(want["conv"]["w"][1]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(want["A_log"][0],
                                  np.log(np.arange(1, nheads + 1,
                                                   dtype=np.float32)))
    dt = np.log1p(np.exp(want["dt_bias"]))          # softplus undoes it
    assert (dt > 0.9e-3).all() and (dt < 0.11).all()
    assert abs(want["conv"]["w"].std() / 0.5 - 1) < 0.1
    ref = ref_ssm.init(jax.random.key(0), ref_config(ARCH, smoke=True))
    np.testing.assert_array_equal(np.asarray(ref["A_log"]), want["A_log"][0])
    np.testing.assert_array_equal(np.asarray(ref["D"]), want["D"][0])
