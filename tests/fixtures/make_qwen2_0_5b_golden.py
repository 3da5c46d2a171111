"""Write ``qwen2_0_5b_golden.npz`` (float32) or ``qwen2_0_5b_golden_bf16.npz``
(bfloat16): the reference LM's logits for qwen2-0.5b at full width, the
goldens that ``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_qwen2_0_5b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_qwen2_0_5b_golden.py --dtype bfloat16

The reference package (``repro.models.lm``) runs qwen2-0.5b's full config in
the dtype given with the weights of ``repro_torch.convert.numpy_lm_params(cfg,
seed=0)`` (rounded to bfloat16 there, as the port rounds them): a prefill
of a batch of 2 prompts of 8 tokens, then 3 decode steps, teacher-forced
with fixed tokens. For each of the 4 steps the file keeps the top-40 logits
of each row (indices and values; the comparison takes the top 32, the next
8 let a near-tie at rank 32 be told from an error), the logsumexp over the
vocabulary and the RMS over its real (unpadded) entries, with the tokens, the seed, each weight leaf's
shape and float64 sum in the dtype used (so a test can check that the
recipe still makes these weights) and the smallest gap between
neighbouring top-32 values. Takes ~1 minute and ~5 GB on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import lm
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_leaves, numpy_lm_params

ARCH, SEED, BATCH, PROMPT, STEPS, TOPK, KEEP = "qwen2-0.5b", 0, 2, 8, 3, 32, 40
OUT = {"float32": Path(__file__).with_name("qwen2_0_5b_golden.npz"),
       "bfloat16": Path(__file__).with_name("qwen2_0_5b_golden_bf16.npz")}


def rounded(x: np.ndarray, dtype: str) -> np.ndarray:
    """``x`` rounded to ``dtype`` (to nearest even, as ``Tensor.copy_`` and
    ``astype`` round), held exactly in float32."""
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(OUT), default="float32")
    dtype = ap.parse_args(argv).dtype
    out = OUT[dtype]
    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    pcfg = dataclasses.replace(port_config(ARCH), dtype=dtype)
    paths, shapes, sums = [], [], []
    for path, x in numpy_lm_leaves(pcfg, SEED):
        paths.append("/".join(map(str, path)))
        shapes.append(x.shape)
        sums.append(rounded(x, dtype).sum(dtype=np.float64))
    tree = numpy_lm_params(pcfg, SEED)
    params = jax.tree.map(lambda x: jnp.asarray(x).astype(cfg.jdtype), tree)
    del tree
    print(f"weights: {time.perf_counter() - t:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
    cache = lm.init_cache(cfg, BATCH, max_len=PROMPT + STEPS)
    logits, cache = jax.jit(lambda p, t, c: lm.prefill(p, cfg, tokens=t, cache=c))(
        params, jnp.asarray(tokens[:, :PROMPT]), cache)
    steps = [np.asarray(logits, dtype=np.float32)]
    decode = jax.jit(lambda p, t, c, n: lm.decode_step(p, cfg, t, c, n))
    for i in range(STEPS):
        logits, cache = decode(params, jnp.asarray(tokens[:, PROMPT + i]), cache,
                               jnp.int32(PROMPT + i))
        steps.append(np.asarray(logits, dtype=np.float32))
    lg = np.stack(steps)                                    # [steps, B, V]
    idx = np.argsort(-lg, axis=-1, kind="stable")[..., :KEEP]
    vals = np.take_along_axis(lg, idx, -1)
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1))).astype(np.float32)
    real = lg[..., :cfg.vocab_size]                         # pad columns: -1e30
    rms = np.sqrt(np.square(real, dtype=np.float64).mean(-1)).astype(np.float32)
    gap = float(np.min(vals[..., :TOPK] - vals[..., 1:TOPK + 1]))
    np.savez_compressed(
        out, arch=ARCH, dtype=dtype, seed=SEED, tokens=tokens,
        prompt_len=PROMPT, top_idx=idx.astype(np.int32),
        top_val=vals.astype(np.float32), lse=lse, rms=rms,
        leaf_paths=np.array(paths), leaf_shapes=np.array(
            [",".join(map(str, s)) for s in shapes]), leaf_sums=np.array(sums),
        min_gap=gap, topk=TOPK)
    print(f"wrote {out} ({out.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s; smallest gap between top-{TOPK} "
          f"neighbours {gap:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
