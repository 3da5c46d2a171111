"""The port's Threefry stream (``repro_torch.core.prng``) against
``jax.random`` on the non-partitionable layout, bit for bit: key data,
``split``, ``fold_in``, raw 32- and 64-bit draws and int32 ``randint`` over
many seeds, shapes and spans, with x64 off and on in the reference (the
annealer draws under ``enable_x64``). The reference runs in one subprocess
(``_torch_ref.run_reference(legacy_prng=True)``).
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_reference

from repro_torch.core import prng

SEEDS = (0, 1, 2, 7, 42, 12345, 65535, 2**31 - 1)
#: Seeds at or above 2**31 are 64-bit seeds: x64 only.
WIDE_SEEDS = (2**31, 2**32 + 5, 2**40 + 3)
SHAPES = ((), (1,), (2,), (3, 5), (4, 4), (7,))
#: (minval, maxval): the annealer's spans (items, PEs), one past 2**16
#: (whose multiplier wraps to 0), spans of 1, empty ranges, negative
#: bounds and the int32 edges.
SPANS = ((0, 3689), (0, 64), (0, 256), (0, 65536), (0, 65537),
         (0, 117972), (0, 502447), (0, 1), (5, 5), (5, 2), (-5, 1000),
         (-2**31, 2**31 - 1), (0, 2**31 - 1))
#: A bound past int32 (clipped, the span one larger): x64 only.
WIDE_SPANS = ((100, 2**31 + 7),)
SPLITS = (1, 2, 3, 8)
FOLD_DATA = (0, 1, 123456789, 2**32 - 1)
MODES = ("x32", "x64")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = f"""
    import jax.numpy as jnp

    def draws(mode, seeds):
        for seed in seeds:
            k = jax.random.key(seed)
            p = f"{{mode}}/{{seed}}"
            res[p + "/key"] = np.asarray(jax.random.key_data(k))
            for n in {SPLITS!r}:
                res[f"{{p}}/split{{n}}"] = np.asarray(
                    jax.random.key_data(jax.random.split(k, n)))
            for d in {FOLD_DATA!r}:
                res[f"{{p}}/fold{{d}}"] = np.asarray(
                    jax.random.key_data(jax.random.fold_in(k, d)))
            for i, shape in enumerate({SHAPES!r}):
                res[f"{{p}}/bits32_{{i}}"] = np.asarray(
                    jax.random.bits(k, shape, jnp.uint32))
                spans = {SPANS!r} + ({WIDE_SPANS!r} if mode == "x64" else ())
                for lo, hi in spans:
                    res[f"{{p}}/randint_{{i}}_{{lo}}_{{hi}}"] = np.asarray(
                        jax.random.randint(k, shape, lo, hi,
                                           dtype=jnp.int32))
            # the annealer's chain: split, then randint of each half
            k1, k2 = jax.random.split(k)
            res[p + "/chain"] = np.asarray([
                jax.random.randint(k1, (), 0, 3689, dtype=jnp.int32),
                jax.random.randint(k2, (), 0, 64, dtype=jnp.int32)])

    draws("x32", {SEEDS!r})
    with jax.enable_x64(True):
        draws("x64", {SEEDS + WIDE_SEEDS!r})
        for i, shape in enumerate({SHAPES!r}):
            res[f"x64/7/bits64_{{i}}"] = np.asarray(
                jax.random.bits(jax.random.key(7), shape, jnp.uint64)
            ).view(np.int64)
    """
    return run_reference(tmp_path_factory, "prng", body, legacy_prng=True)


def _seeds(mode):
    return SEEDS if mode == "x32" else SEEDS + WIDE_SEEDS


def _eq(got: torch.Tensor, want: np.ndarray, label):
    assert tuple(got.shape) == want.shape, (label, got.shape, want.shape)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64), err_msg=str(label))


@pytest.mark.parametrize("mode", MODES)
def test_key_split_fold_in(reference, mode):
    for seed in _seeds(mode):
        p = f"{mode}/{seed}"
        k = prng.key(seed)
        _eq(k, reference[p + "/key"], p)
        for n in SPLITS:
            _eq(prng.split(k, n), reference[f"{p}/split{n}"], (p, n))
        for d in FOLD_DATA:
            _eq(prng.fold_in(k, d), reference[f"{p}/fold{d}"], (p, d))


@pytest.mark.parametrize("mode", MODES)
def test_random_bits(reference, mode):
    for seed in _seeds(mode):
        k = prng.key(seed)
        for i, shape in enumerate(SHAPES):
            _eq(prng.random_bits(k, 32, shape),
                reference[f"{mode}/{seed}/bits32_{i}"], (seed, shape))
    if mode == "x64":
        for i, shape in enumerate(SHAPES):
            _eq(prng.random_bits(prng.key(7), 64, shape),
                reference[f"x64/7/bits64_{i}"], shape)


@pytest.mark.parametrize("mode,span", [(m, s) for m in MODES for s in SPANS]
                         + [("x64", s) for s in WIDE_SPANS],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}_{v[1]}")
def test_randint(reference, mode, span):
    lo, hi = span
    for seed in _seeds(mode):
        k = prng.key(seed)
        for i, shape in enumerate(SHAPES):
            got = prng.randint(k, shape, lo, hi)
            assert got.dtype == torch.int32
            _eq(got, reference[f"{mode}/{seed}/randint_{i}_{lo}_{hi}"],
                (seed, shape, span))


@pytest.mark.parametrize("mode", MODES)
def test_annealer_chain_and_batched_keys(reference, mode):
    """The annealer's proposal (split, then a randint of each half), and a
    batch of keys drawn at once equal to each key drawn alone."""
    seeds = _seeds(mode)
    keys = torch.stack([prng.key(s) for s in seeds])
    halves = prng.split(keys, 2)
    got = torch.stack([prng.randint(halves[:, 0], (), 0, 3689),
                       prng.randint(halves[:, 1], (), 0, 64)], dim=-1)
    for row, seed in zip(got, seeds):
        _eq(row, reference[f"{mode}/{seed}/chain"], seed)
    for n in SPLITS:
        batched = prng.split(keys, n)
        for row, seed in zip(batched, seeds):
            _eq(row, reference[f"{mode}/{seed}/split{n}"], (seed, n))


def test_x32_and_x64_agree_below_2_31(reference):
    """Seeds in [0, 2**31) give the same bits with x64 off and on, so the
    annealer's stream does not depend on the ambient mode."""
    for seed in SEEDS:
        for key in ("key", "split2", "fold1", "chain", "randint_3_0_3689"):
            np.testing.assert_array_equal(reference[f"x32/{seed}/{key}"],
                                          reference[f"x64/{seed}/{key}"])


def test_words_stay_in_range():
    k = prng.key(-1)
    assert k.tolist() == [2**32 - 1, 2**32 - 1]
    out = prng.split(torch.stack([prng.key(s) for s in range(64)]), 4)
    assert out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < 2**32
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(prng.key(0), 16, (2,))
