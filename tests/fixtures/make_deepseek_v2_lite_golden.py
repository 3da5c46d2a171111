"""Write ``deepseek_v2_lite_golden.npz``: the reference LM's logits and MoE
routing for deepseek-v2-lite-16b at full width and depth 2, float32, the
golden that ``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_deepseek_v2_lite_golden.py

The reference package (``repro.models.lm``) runs deepseek-v2-lite-16b's full
config (d_model 2048, 16 heads, MLA with kv_lora_rank 512 and rope / nope /
v 64 / 128 / 128, 64 routed experts top-6 + 2 shared at d_ff_expert 1408,
vocab 102400) cut to 2 layers (layer 0 dense at d_ff 10944, layer 1 MoE:
~1.09 B parameters) in float32, with the weights of
``repro_torch.convert.numpy_lm_params(cfg, seed=0)``: a prefill of a batch
of 2 prompts of 64 tokens (capacity 8 a group and expert), then 3 decode
steps, teacher-forced with fixed tokens. For each of the 4 steps the file
keeps the top-40 logits of each row (indices and values; the comparison
takes the top 32), the logsumexp over the vocabulary and the RMS over its
real entries. For the MoE layer's prefill it keeps the routing: each
token's top-6 experts (``route_idx``), their router probabilities and the
7th (``route_prob``, to tell a near-tie from an error), the keep mask of
the capacity cut (``route_keep``, token-major as the reference's
assignments) and, per group and expert, the gap between the criticality keys
on either side of the cut (``route_cut_gap``, inf where the expert took no
more than its capacity). The routing is the reference's own arithmetic
(``repro/models/moe.py`` lines 76-100) on the MoE input that the reference's
prefill computed, read out of it with ``jax.debug.callback``; its dropped
count must equal the ``moe_dropped`` of the reference's ``forward`` on the
same prompt. Also each weight leaf's path, shape and float64 sum, so that a
test can check that the recipe still makes these weights. Takes ~1.5
minutes and ~10 GB on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import blocks as ref_blocks
from repro.models import lm
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_leaves, numpy_lm_params

ARCH, SEED, BATCH, PROMPT, STEPS, TOPK, KEEP = (
    "deepseek-v2-lite-16b", 0, 2, 64, 3, 32, 40)
LAYERS = 2
OUT = Path(__file__).with_name("deepseek_v2_lite_golden.npz")


def cut(cfg):
    return dataclasses.replace(cfg, num_layers=LAYERS, dtype="float32")


def routing(x, w, cfg):
    """The reference's top-k and capacity cut (``repro/models/moe.py``,
    criticality order) on the MoE input x [g, t, d]: top-k ids, the k + 1
    largest probabilities, the keep mask [g, t * k] and the gap between the
    sorted keys at the cut per (group, expert)."""
    m = cfg.moe
    g, t, _ = x.shape
    e, k = m.num_experts, m.top_k
    cap = min(max(1, math.ceil(k * t * m.capacity_factor / e)), t * k)
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ w, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    top_next, _ = jax.lax.top_k(probs, k + 1)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    fe = topi.reshape(g, t * k)
    fw = topw.reshape(g, t * k)
    key = fe.astype(jnp.float32) * 2.0 + (1.0 - fw)
    order = jnp.argsort(key, axis=1)
    fe_srt = jnp.take_along_axis(fe, order, axis=1)
    oh = jax.nn.one_hot(fe_srt, e, dtype=jnp.int32)
    pos_srt = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1,
                                  fe_srt[..., None], axis=-1)[..., 0]
    inv = jnp.argsort(order, axis=1)
    mypos = np.asarray(jnp.take_along_axis(pos_srt, inv, axis=1))
    key, fe = np.asarray(key), np.asarray(fe)
    gap = np.full((g, e), np.inf, np.float32)
    for gi in range(g):
        for ei in range(e):
            ks = np.sort(key[gi][fe[gi] == ei])
            if len(ks) > cap:
                gap[gi, ei] = ks[cap] - ks[cap - 1]
    return (np.asarray(topi, np.int32), np.asarray(top_next, np.float32),
            mypos < cap, gap)


def main() -> int:
    t = time.perf_counter()
    cfg = cut(get_config(ARCH))
    pcfg = cut(port_config(ARCH))
    paths, shapes, sums = [], [], []
    for path, x in numpy_lm_leaves(pcfg, SEED):
        paths.append("/".join(map(str, path)))
        shapes.append(x.shape)
        sums.append(x.sum(dtype=np.float64))
    tree = numpy_lm_params(pcfg, SEED)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    print(f"weights: {time.perf_counter() - t:.1f} s", flush=True)

    seen = []
    apply = ref_blocks.moe_mod.apply

    def recording(p, c, x):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), x)
        return apply(p, c, x)

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
    cache = lm.init_cache(cfg, BATCH, max_len=PROMPT + STEPS)
    ref_blocks.moe_mod.apply = recording
    try:
        logits, cache = jax.jit(lambda p, t, c: lm.prefill(p, cfg, tokens=t, cache=c))(
            params, jnp.asarray(tokens[:, :PROMPT]), cache)
        jax.effects_barrier()
    finally:
        ref_blocks.moe_mod.apply = apply
    if len(seen) != LAYERS - 1:
        raise AssertionError(f"{len(seen)} MoE inputs recorded, want {LAYERS - 1}")
    router = [params["segments"][1]["ffn"]["router"]["w"][j]
              for j in range(LAYERS - 1)]
    idx, prob, keep, gap = map(np.stack, zip(*(
        routing(x, w, cfg) for x, w in zip(seen, router))))
    _, metrics = jax.jit(lambda p, t: lm.forward(p, cfg, tokens=t))(
        params, jnp.asarray(tokens[:, :PROMPT]))
    if int((~keep).sum()) != int(metrics["moe_dropped"]):
        raise AssertionError(f"routing drops {int((~keep).sum())}, the "
                             f"reference's forward {metrics['moe_dropped']}")

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
        OUT, arch=ARCH, dtype="float32", seed=SEED, layers=LAYERS,
        tokens=tokens, prompt_len=PROMPT, top_idx=top.astype(np.int32),
        top_val=vals.astype(np.float32), lse=lse, rms=rms, min_gap=min_gap,
        topk=TOPK, route_idx=idx, route_prob=prob, route_keep=keep,
        route_cut_gap=gap, moe_dropped=int((~keep).sum()),
        leaf_paths=np.array(paths), leaf_shapes=np.array(
            [",".join(map(str, s)) for s in shapes]), leaf_sums=np.array(sums))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s; smallest gap between top-{TOPK} "
          f"neighbours {min_gap:.3e}; prefill drops {int((~keep).sum())} of "
          f"{keep.size} assignments", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
