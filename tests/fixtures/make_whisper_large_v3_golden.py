"""Write ``whisper_large_v3_golden.npz`` (float32) or
``whisper_large_v3_golden_bf16.npz`` (bfloat16): the reference LM's logits
for whisper-large-v3 at full width and depth, the goldens that
``chip_smoke.py`` holds the port against on the card, and in float32 the
same at depth 2, which the CPU tests hold the port against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_whisper_large_v3_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_whisper_large_v3_golden.py --dtype bfloat16

The reference package (``repro.models.lm``) runs whisper-large-v3's full
config (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64, d_ff
5120, LayerNorm, a GELU MLP with biases, sinusoidal positions, vocab 51866
padded to 51968, tied head; 1,535,841,280 parameters) in the dtype given
with the weights of ``repro_torch.convert.numpy_lm_leaves(cfg, seed=0)``
(in bfloat16 each leaf as ``make_mamba2_130m_golden.py`` hands it over): the
encoder over a batch of 2 x 150 stub frame embeddings (150 is not a
multiple of the kernel's 64-key tiles), a decoder prefill of 75 tokens,
then 3 decode steps, teacher-forced with fixed tokens. The frames
(``standard_normal``, float32) and then the tokens are drawn from
``np.random.default_rng(0)``, in that order; the file keeps the tokens and
the frames' float64 sum. For each of the 4 steps it keeps the top-40
logits of each row (indices and values; the comparison takes the top 32,
the next 8 let a near-tie at rank 32 be told from an error), the logsumexp
over the vocabulary and the RMS over its real (unpadded) entries, the
smallest gap between neighbouring top-32 values, and each weight leaf's
path, shape, dtype and float64 sum. The float32 golden's ``small_*``
arrays are the same run cut to 2 encoder and 2 decoder layers (the recipe
at that depth). The weights go to JAX leaf by leaf, so the peak stays near
one copy of them: ~36 s and 6.8 GiB at its peak on the CPU in float32, ~41
s and 9.4 GiB in bfloat16.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from make_mamba2_130m_golden import (DTYPES, out_path, params_of, peak_gib,
                                     summary)
from repro.configs import get_config
from repro.models import lm
from repro_torch.configs import get_config as port_config

ARCH, SEED, BATCH, FRAMES, PROMPT, STEPS, TOPK = (
    "whisper-large-v3", 0, 2, 150, 75, 3, 32)
SMALL = 2


def cut(cfg, layers, dtype):
    return dataclasses.replace(
        cfg, num_layers=layers, dtype=dtype,
        encdec=dataclasses.replace(cfg.encdec, enc_layers=layers))


def inputs(d_model: int, vocab: int):
    """The frames [BATCH, FRAMES, d_model] float32, then the tokens [BATCH,
    PROMPT + STEPS] int32, from ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    frames = rng.standard_normal((BATCH, FRAMES, d_model), dtype=np.float32)
    tokens = rng.integers(0, vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    return frames, tokens


def run(layers: int, dtype: str) -> dict:
    t = time.perf_counter()
    cfg = cut(get_config(ARCH), layers, dtype)
    pcfg = cut(port_config(ARCH), layers, dtype)
    params, leaves = params_of(cfg, pcfg, SEED)
    print(f"depth {layers}: weights {time.perf_counter() - t:.1f} s",
          flush=True)
    frames, tokens = inputs(cfg.d_model, cfg.vocab_size)
    cache = lm.encdec_init_cache(cfg, BATCH, PROMPT + STEPS, FRAMES)
    logits, cache = jax.jit(
        lambda p, f, t, c: lm.prefill_encdec(p, cfg, f, t, c))(
        params, jnp.asarray(frames), jnp.asarray(tokens[:, :PROMPT]), cache)
    steps = [logits]
    decode = jax.jit(lambda p, t, c, n: lm.decode_step_encdec(p, cfg, t, c, n))
    for i in range(STEPS):
        logits, cache = decode(params, jnp.asarray(tokens[:, PROMPT + i]),
                               cache, jnp.int32(PROMPT + i))
        steps.append(logits)
    stats = summary(steps, cfg.vocab_size)
    print(f"depth {layers}: {time.perf_counter() - t:.1f} s; smallest gap "
          f"between top-{TOPK} neighbours {stats['min_gap']:.3e}", flush=True)
    return dict(**stats, **leaves)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=DTYPES, default="float32")
    dtype = ap.parse_args(argv).dtype
    out = out_path("whisper_large_v3", dtype)
    t = time.perf_counter()
    layers = get_config(ARCH).num_layers
    full = run(layers, dtype)
    # The CPU tests' depth-2 arrays are the float32 golden's only.
    small = run(SMALL, dtype) if dtype == "float32" else {}
    frames, tokens = inputs(get_config(ARCH).d_model, get_config(ARCH).vocab_size)
    extra = dict(small_layers=SMALL) if small else {}
    np.savez_compressed(
        out, arch=ARCH, dtype=dtype, seed=SEED, layers=layers, tokens=tokens,
        prompt_len=PROMPT, frames_len=FRAMES,
        frames_sum=frames.sum(dtype=np.float64), **extra, **full,
        **{f"small_{k}": v for k, v in small.items()
           if not k.startswith("leaf_")})
    print(f"wrote {out} ({out.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s, peak RSS {peak_gib():.1f} GiB",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
