"""Write ``mamba2_130m_golden.npz``: the reference LM's logits for
mamba2-130m at full width and depth, float32, the golden that
``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_mamba2_130m_golden.py

The reference package (``repro.models.lm``) runs mamba2-130m's full config
(24 Mamba2 layers, d_model 768, d_inner 1536, 24 SSM heads of 64, d_state
128, chunk 256, vocab 50280 padded to 50432, tied head; ~129 M parameters)
in float32 with the weights of ``repro_torch.convert.numpy_lm_params(cfg,
seed=0)``: a prefill of a batch of 2 prompts of 300 tokens (past one SSD
chunk, not a multiple of it), then 3 decode steps, teacher-forced with
fixed tokens. For each of the 4 steps the file keeps the top-40 logits of
each row (indices and values; the comparison takes the top 32, the next 8
let a near-tie at rank 32 be told from an error), the logsumexp over the
vocabulary and the RMS over its real (unpadded) entries, the smallest gap
between neighbouring top-32 values, and each weight leaf's path, shape and
float64 sum, so that a test can check that the recipe still makes these
weights. :func:`make` writes such a golden for any arch and depth
(``make_zamba2_7b_golden.py`` uses it). Takes ~10 s and ~1 GB on the CPU.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import lm
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_leaves, numpy_lm_params

SEED, BATCH, PROMPT, STEPS, TOPK, KEEP = 0, 2, 300, 3, 32, 40


def make(arch: str, layers: int, out: Path) -> None:
    t = time.perf_counter()

    def cut(cfg):
        return dataclasses.replace(cfg, num_layers=layers, dtype="float32")

    cfg, pcfg = cut(get_config(arch)), cut(port_config(arch))
    paths, shapes, sums = [], [], []
    for path, x in numpy_lm_leaves(pcfg, SEED):
        paths.append("/".join(map(str, path)))
        shapes.append(x.shape)
        sums.append(x.sum(dtype=np.float64))
    tree = numpy_lm_params(pcfg, SEED)
    params = jax.tree.map(jnp.asarray, tree)
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
    top = np.argsort(-lg, axis=-1, kind="stable")[..., :KEEP]
    vals = np.take_along_axis(lg, top, -1)
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1))).astype(np.float32)
    real = lg[..., :cfg.vocab_size]                         # pad columns: -1e30
    rms = np.sqrt(np.square(real, dtype=np.float64).mean(-1)).astype(np.float32)
    min_gap = float(np.min(vals[..., :TOPK] - vals[..., 1:TOPK + 1]))
    np.savez_compressed(
        out, arch=arch, dtype="float32", seed=SEED, layers=layers,
        tokens=tokens, prompt_len=PROMPT, top_idx=top.astype(np.int32),
        top_val=vals.astype(np.float32), lse=lse, rms=rms, min_gap=min_gap,
        topk=TOPK, leaf_paths=np.array(paths), leaf_shapes=np.array(
            [",".join(map(str, s)) for s in shapes]), leaf_sums=np.array(sums))
    print(f"wrote {out} ({out.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s; smallest gap between top-{TOPK} "
          f"neighbours {min_gap:.3e}", flush=True)


def main() -> int:
    make("mamba2-130m", 24, Path(__file__).with_name("mamba2_130m_golden.npz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
