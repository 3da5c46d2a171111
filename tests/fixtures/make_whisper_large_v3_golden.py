"""Write ``whisper_large_v3_golden.npz``: the reference LM's logits for
whisper-large-v3 at full width and depth, float32, the golden that
``chip_smoke.py`` holds the port against on the card, and the same at depth
2, which the CPU tests hold the port against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_whisper_large_v3_golden.py

The reference package (``repro.models.lm``) runs whisper-large-v3's full
config (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64, d_ff
5120, LayerNorm, a GELU MLP with biases, sinusoidal positions, vocab 51866
padded to 51968, tied head; 1,535,841,280 parameters) in float32 with the
weights of ``repro_torch.convert.numpy_lm_params(cfg, seed=0)``: the
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
path, shape and float64 sum. The ``small_*`` arrays are the same run cut
to 2 encoder and 2 decoder layers (the recipe at that depth). The weights
go to JAX leaf by leaf, so the peak stays near one copy of them (~6.2 GB).
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
from repro_torch.convert import numpy_lm_leaves

ARCH, SEED, BATCH, FRAMES, PROMPT, STEPS, TOPK, KEEP = (
    "whisper-large-v3", 0, 2, 150, 75, 3, 32, 40)
SMALL = 2
OUT = Path(__file__).with_name("whisper_large_v3_golden.npz")


def cut(cfg, layers):
    return dataclasses.replace(
        cfg, num_layers=layers, dtype="float32",
        encdec=dataclasses.replace(cfg.encdec, enc_layers=layers))


def inputs(d_model: int, vocab: int):
    """The frames [BATCH, FRAMES, d_model] float32, then the tokens [BATCH,
    PROMPT + STEPS] int32, from ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    frames = rng.standard_normal((BATCH, FRAMES, d_model), dtype=np.float32)
    tokens = rng.integers(0, vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    return frames, tokens


def params_of(pcfg):
    """The recipe's tree as JAX arrays, converted leaf by leaf, and each
    leaf's path, shape and float64 sum."""
    tree: dict = {"segments": [{}]}
    paths, shapes, sums = [], [], []
    for path, x in numpy_lm_leaves(pcfg, SEED):
        paths.append("/".join(map(str, path)))
        shapes.append(x.shape)
        sums.append(x.sum(dtype=np.float64))
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(x)
        del x
    return tree, paths, shapes, sums


def run(layers: int) -> dict:
    t = time.perf_counter()
    cfg = cut(get_config(ARCH), layers)
    pcfg = cut(port_config(ARCH), layers)
    params, paths, shapes, sums = params_of(pcfg)
    print(f"depth {layers}: weights {time.perf_counter() - t:.1f} s",
          flush=True)
    frames, tokens = inputs(cfg.d_model, cfg.vocab_size)
    cache = lm.encdec_init_cache(cfg, BATCH, PROMPT + STEPS, FRAMES)
    logits, cache = jax.jit(
        lambda p, f, t, c: lm.prefill_encdec(p, cfg, f, t, c))(
        params, jnp.asarray(frames), jnp.asarray(tokens[:, :PROMPT]), cache)
    steps = [np.asarray(logits, dtype=np.float32)]
    decode = jax.jit(lambda p, t, c, n: lm.decode_step_encdec(p, cfg, t, c, n))
    for i in range(STEPS):
        logits, cache = decode(params, jnp.asarray(tokens[:, PROMPT + i]),
                               cache, jnp.int32(PROMPT + i))
        steps.append(np.asarray(logits, dtype=np.float32))
    lg = np.stack(steps)                                    # [steps, B, V]
    top = np.argsort(-lg, axis=-1, kind="stable")[..., :KEEP]
    vals = np.take_along_axis(lg, top, -1)
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1))).astype(np.float32)
    real = lg[..., :cfg.vocab_size]                         # pad columns: -1e30
    rms = np.sqrt(np.square(real, dtype=np.float64).mean(-1)).astype(np.float32)
    gap = float(np.min(vals[..., :TOPK] - vals[..., 1:TOPK + 1]))
    print(f"depth {layers}: {time.perf_counter() - t:.1f} s; smallest gap "
          f"between top-{TOPK} neighbours {gap:.3e}", flush=True)
    return dict(top_idx=top.astype(np.int32), top_val=vals.astype(np.float32),
                lse=lse, rms=rms, min_gap=gap, leaf_paths=np.array(paths),
                leaf_shapes=np.array([",".join(map(str, s)) for s in shapes]),
                leaf_sums=np.array(sums))


def main() -> int:
    t = time.perf_counter()
    full = run(get_config(ARCH).num_layers)
    small = run(SMALL)
    frames, tokens = inputs(get_config(ARCH).d_model, get_config(ARCH).vocab_size)
    np.savez_compressed(
        OUT, arch=ARCH, dtype="float32", seed=SEED,
        layers=get_config(ARCH).num_layers, small_layers=SMALL, tokens=tokens,
        prompt_len=PROMPT, frames_len=FRAMES,
        frames_sum=frames.sum(dtype=np.float64), topk=TOPK,
        **full, **{f"small_{k}": v for k, v in small.items()
                   if not k.startswith("leaf_")})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
