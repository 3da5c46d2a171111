"""Threefry-2x32 keys and draws, bit for bit those of JAX's default PRNG.

The reference package draws its annealer's proposals (and, later, its
surrogate's training placements) from ``jax.random`` keys. This module is
the port's copy of what it uses:

  * :func:`key` — the raw ``[2]`` key data of ``jax.random.key(seed)``;
  * :func:`threefry2x32` — the Threefry-2x32 block function (20 rounds);
  * :func:`split`, :func:`fold_in`, :func:`random_bits` — the key
    derivations and the raw bit draws;
  * :func:`randint` — ``jax.random.randint`` for int32, with JAX's two draws
    and its ``2**32 mod span`` multiplier.

All of it follows the **non-partitionable** layout of the counters
(``jax_threefry_partitionable=False``): ``split(key, n)`` hashes the counter
pairs ``(j, n + j)`` and reads the key ``j`` from the flat output's words
``2j`` and ``2j + 1``, and ``random_bits`` hashes ``(j, ceil(m/2) + j)``.
The placement goldens of ``BENCH_overlay.json`` were recorded on that
layout; the partitionable one, JAX's default from 0.5 on, gives other
streams and is not ported.

Words: a uint32 word is held in ``torch.int64`` in ``[0, 2**32)``, and every
operation that can carry past bit 31 is masked back, as the RDY words of
:mod:`repro_torch.core.bitvec` are. A key is a ``[..., 2]`` int64 tensor;
every function takes a batch of keys on its leading axes and treats each key
as JAX treats one (as ``jax.vmap`` does). Plain tensor code on any device;
the annealer's CUDA kernel (``kernels/csrc/anneal.cu``) carries its own
inline copy of the block function and of :func:`randint`.
"""
from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def _words(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.int64, device=device)
    return t & _LOW32


def key(seed: int, device=None) -> torch.Tensor:
    """``[2]`` int64 key data of ``jax.random.key(seed)``: the seed's high
    and low 32 bits (a 64-bit seed, as under ``jax_enable_x64``; seeds in
    ``[0, 2**31)`` give the same key either way)."""
    s = int(seed) % 2 ** 64
    return torch.tensor([s >> 32, s & _LOW32], dtype=torch.int64,
                        device=device)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _LOW32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function of JAX's ``threefry2x32_p``, 20
    rounds, on broadcast int64 word tensors. Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _LOW32
    x1 = (x1 + ks[1]) & _LOW32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _LOW32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _LOW32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _LOW32
    return x0, x1


def _hash_counts(keys: torch.Tensor, m: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(m))`` per key: ``[..., 2]`` -> ``[..., m]``.

    The flat counters are cut in halves (an odd count padded with one 0
    word), the halves hashed as pairs, and the two outputs concatenated."""
    if m >= 2 ** 32:
        raise NotImplementedError("more than 2**32 - 1 counter words")
    h = (m + 1) // 2
    counts = torch.arange(2 * h, dtype=torch.int64, device=keys.device)
    counts[m:] = 0
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, counts[:h], counts[h:])
    return torch.cat([y0, y1], dim=-1)[..., :m]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` per key: ``[..., 2]`` ->
    ``[..., num, 2]``."""
    flat = _hash_counts(keys, 2 * num)
    return flat.reshape(tuple(keys.shape[:-1]) + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` per key (``data`` a uint32 scalar
    or a tensor broadcast against the keys' batch shape)."""
    d = _words(data, keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 | uint64)`` per key:
    ``[..., 2]`` -> ``[..., *shape]`` int64 words (a 64-bit word is held as
    its two's-complement int64)."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= int(s)
    batch = tuple(keys.shape[:-1])
    if bit_width == 32:
        return _hash_counts(keys, size).reshape(batch + shape)
    if bit_width == 64:
        bits = _hash_counts(keys, 2 * size)
        hi, lo = bits[..., :size], bits[..., size:]
        return ((hi << 32) | lo).reshape(batch + shape)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _clip_int32(v: int) -> int:
    return min(max(int(v), INT32_MIN), INT32_MAX)


def _mul32(a, b):
    """``(a * b) mod 2**32`` of two words, exact in int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _LOW32


def randint(keys: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` per
    key: ``[..., 2]`` -> ``[..., *shape]`` int32.

    Two 32-bit draws per value (``higher`` from the key's first split half,
    ``lower`` from its second) and the offset
    ``(higher % span * mult + lower % span) % span`` in uint32,
    with the multiplier ``mult = ((2**16 % span)**2 mod 2**32) % span``
    (which is 0, not ``2**32 % span``, for spans above ``2**16``). Bounds
    are clipped to int32; ``maxval <= minval`` gives ``minval``."""
    out_of_range = int(maxval) > INT32_MAX
    lo_v, hi_v = _clip_int32(minval), _clip_int32(maxval)
    span = (hi_v - lo_v) & _LOW32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _LOW32
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], 32, shape)
    lower = random_bits(k[..., 1, :], 32, shape)
    if span == 0:  # 2**32 values: the remainders are the words themselves
        offset = (higher * 0 + lower) & _LOW32
    else:
        mult = (2 ** 16) % span
        mult = ((mult * mult) & _LOW32) % span  # wraps to 0 above 2**16
        offset = (_mul32(higher % span, torch.full_like(higher, mult))
                  + lower % span) & _LOW32
        offset = offset % span
    val = (lo_v + offset) & _LOW32
    return torch.where(val >= 2 ** 31, val - 2 ** 32, val).to(torch.int32)
