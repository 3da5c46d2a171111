"""Sampled decoding and the partitionable Threefry layout, against JAX on
the CPU.

``jax.random.categorical(key, logits / temperature)``, the reference's
sampled decode step, is the argmax of ``logits / T`` plus Gumbel noise
whose uniforms come from Threefry bits in JAX's default (partitionable)
counter layout. Held here: ``prng.random_bits(..., partitionable=True)``
(32 and 64 bits) and ``prng.uniform`` bit-equal to ``jax.random.bits`` and
``jax.random.uniform`` under that layout; ``prng.gumbel`` within 2 float32
ulps of ``jax.random.gumbel`` (ulps of ``max(|g|, 1)``: the two logarithms
differ by an ulp or so, and near g = 0 the outer one cancels); the sampled
tokens equal to ``jax.random.categorical``'s wherever the top-two margin of
the perturbed logits exceeds 1e-5; the non-partitionable stream
(placement's) unchanged; and sampled decoding through both packages' serve
steps, a dense and the whisper smoke LM (the two decode paths), the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.train.steps import make_decode_step, make_prefill_step

SEEDS = (0, 1, 7, 42, 2**31 - 1)
SHAPES = ((), (1,), (5,), (3, 7), (2, 3, 4), (2, 1000))
#: Tokens must be equal where the top-two margin of the perturbed logits
#: exceeds this (the Gumbel noise agrees within 2 ulps of values up to ~20).
MARGIN = 1e-5


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_partitionable_bits_equal_jax(seed):
    k, kt = jax.random.key(seed), prng.key(seed)
    with jax.threefry_partitionable(True):
        for shape in SHAPES:
            want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
            got = prng.random_bits(kt, 32, shape, partitionable=True)
            assert got.shape == shape and got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        with jax.enable_x64(True):
            for shape in SHAPES:
                want = np.asarray(jax.random.bits(k, shape, jnp.uint64))
                got = prng.random_bits(kt, 64, shape, partitionable=True)
                np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_partitionable_bits_per_key_batch():
    """A batch of keys draws as each key alone (as ``jax.vmap`` does)."""
    keys = torch.stack([prng.key(s) for s in SEEDS])
    got = prng.random_bits(keys, 32, (4, 3), partitionable=True)
    assert got.shape == (len(SEEDS), 4, 3)
    with jax.threefry_partitionable(True):
        for i, s in enumerate(SEEDS):
            want = np.asarray(jax.random.bits(jax.random.key(s), (4, 3),
                                              jnp.uint32))
            np.testing.assert_array_equal(got[i].numpy().astype(np.uint32),
                                          want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32).tiny),
                                                1.0), (-2.0, 3.5)])
@pytest.mark.parametrize("seed", SEEDS)
def test_partitionable_uniform_equals_jax(seed, lo, hi):
    k, kt = jax.random.key(seed), prng.key(seed)
    with jax.threefry_partitionable(True):
        for shape in SHAPES + ((1, 151936),):
            want = jax.random.uniform(k, shape, jnp.float32, lo, hi)
            got = prng.uniform(kt, shape, lo, hi)
            assert got.dtype == torch.float32 and got.shape == shape
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps(seed):
    k, kt = jax.random.key(seed), prng.key(seed)
    shape = (4, 151936)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
    got = prng.gumbel(kt, shape).numpy()
    assert np.isfinite(got).all()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_tokens_equal_jax_categorical(seed, temperature):
    """``steps.sample`` against ``jax.random.categorical`` on the same f32
    logits, a vocabulary of qwen2-0.5b's padded width."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((8, 151936)) * 3).astype(np.float32)
    logits[:, 151900:] = -1e30                      # masked pad columns
    k = jax.random.key(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)
                                                 / temperature, axis=-1))
        noisy = np.asarray(jax.random.gumbel(k, logits.shape)
                           + jnp.asarray(logits) / temperature)
    got = steps.sample(prng.key(seed), torch.from_numpy(logits), temperature)
    assert got.dtype == torch.int32 and got.shape == (8,)
    top2 = np.sort(noisy, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert clear.sum() >= 6
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    assert (got.numpy() < 151900).all()


def test_non_partitionable_stream_unchanged():
    """``random_bits``' default layout stays the non-partitionable one,
    placement's: its draws and ``split`` equal JAX's under
    ``jax_threefry_partitionable=False`` and differ from the partitionable
    draws of the same key."""
    for seed in SEEDS:
        k, kt = jax.random.key(seed), prng.key(seed)
        with jax.threefry_partitionable(False):
            for shape in SHAPES:
                want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
                got = prng.random_bits(kt, 32, shape)
                np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                              want)
            want = np.asarray(jax.random.key_data(jax.random.split(k, 3)))
            np.testing.assert_array_equal(prng.split(kt, 3).numpy(), want)
        a = prng.random_bits(kt, 32, (64,))
        b = prng.random_bits(kt, 32, (64,), partitionable=True)
        assert not torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-large-v3"])
def test_sampled_decode_steps_match_reference(arch):
    """Sampled decoding through both packages' serve steps (whisper: over
    24 frames), the key of step i ``fold_in(key, i)`` on both sides, the
    decode teacher-forced with the reference's tokens: the logits within
    1e-4 and the tokens equal wherever the reference's top-two margin of
    ``gumbel + logits / T`` exceeds 1e-3 (the logits' tolerance, with
    room)."""
    cfg, rcfg = get_config(arch, smoke=True), ref_config(arch, smoke=True)
    params = ref_lm.init(jax.random.key(1), rcfg)
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                         device="cpu")
    b, p, n, temp = 2, 8, 4, 0.9
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal((b, 24, cfg.d_model)).astype(
            np.float32)
        cache = ref_lm.encdec_init_cache(rcfg, b, p + n, 24)
        tcache = lm.encdec_init_cache(cfg, b, p + n, 24, device="cpu")
    else:
        cache = ref_lm.init_cache(rcfg, b, max_len=p + n)
        tcache = lm.init_cache(cfg, b, max_len=p + n, device="cpu")
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    _, cache = ref_prefill_step(rcfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    _, tcache = make_prefill_step(cfg)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
    ref_step = ref_decode_step(rcfg, greedy=False, temperature=temp)
    step = make_decode_step(cfg, greedy=False, temperature=temp)
    cur = batch["tokens"][:, -1].copy()
    compared = 0
    with jax.threefry_partitionable(True):
        for i in range(n):
            key = jax.random.fold_in(jax.random.key(5), i)
            want, lg, cache = ref_step(params, jnp.asarray(cur), cache,
                                       jnp.int32(p + i), key)
            got, tlg, tcache = step(model, torch.from_numpy(cur), tcache,
                                    p + i, prng.fold_in(prng.key(5), i))
            np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), rtol=1e-4,
                                       atol=1e-4)
            noisy = np.asarray(jax.random.gumbel(key, lg.shape) + lg / temp)
            top2 = np.sort(noisy, -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 1e-3
            np.testing.assert_array_equal(got.numpy()[clear],
                                          np.asarray(want)[clear])
            compared += int(clear.sum())
            cur = np.array(want, dtype=np.int32)
    assert compared >= b * n - 1
