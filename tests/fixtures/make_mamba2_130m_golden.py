"""Write ``mamba2_130m_golden.npz`` (float32) or
``mamba2_130m_golden_bf16.npz`` (bfloat16): the reference LM's logits for
mamba2-130m at full width and depth, the goldens that ``chip_smoke.py``
holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_mamba2_130m_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_mamba2_130m_golden.py --dtype bfloat16

The reference package (``repro.models.lm``) runs mamba2-130m's full config
(24 Mamba2 layers, d_model 768, d_inner 1536, 24 SSM heads of 64, d_state
128, chunk 256, vocab 50280 padded to 50432, tied head; ~129 M parameters)
in the dtype given, with the weights of ``repro_torch.convert.numpy_lm_leaves(cfg,
seed=0)``: a prefill of a batch of 2 prompts of 300 tokens (past one SSD
chunk, not a multiple of it), then 3 decode steps, teacher-forced with
fixed tokens. For each of the 4 steps the file keeps the top-40 logits of
each row (indices and values; the comparison takes the top 32, the next 8
let a near-tie at rank 32 be told from an error), the logsumexp over the
vocabulary and the RMS over its real (unpadded) entries, the smallest gap
between neighbouring top-32 values, and each weight leaf's path, shape and
float64 sum, so that a test can check that the recipe still makes these
weights.

In bfloat16 each leaf goes to the reference in the dtype its own ``lm.init``
gives it: bf16, but float32 for a MoE router and Mamba2's ``A_log``, ``D``
and ``dt_bias``, as the port keeps them. A leaf is rounded to bf16 to
nearest even, as the port's ``Tensor.copy_`` rounds it, and its sum is
that of the rounded values (:func:`leaf_sum`); the file also keeps each
leaf's dtype. The tokens, seed and prompt are the float32 golden's, so one
draw of the weights serves both.

:func:`make` writes such a golden for any arch, depth and dtype (the other
``make_*_golden.py`` use it), each leaf handed to JAX as the recipe yields
it, so the peak stays near one copy of the weights in the dtype used.
``routing_segment`` also keeps that MoE segment's routing (:func:`routing`)
of the prefill (``route_*``) and of each decode step (``step_route_*``).
mamba2-130m takes ~8 s and 1.1 GiB at its peak in float32 on the CPU, ~8 s
and 1.4 GiB in bfloat16.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import resource
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.configs import get_config
from repro.models import blocks as ref_blocks
from repro.models import lm
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_leaves

SEED, BATCH, PROMPT, STEPS, TOPK, KEEP = 0, 2, 300, 3, 32, 40
DTYPES = ("float32", "bfloat16")
#: Elements a leaf is rounded to bf16 at a time (:func:`leaf_sum`).
CHUNK = 1 << 22


def out_path(stem: str, dtype: str) -> Path:
    """``<stem>_golden.npz`` (float32) or ``<stem>_golden_bf16.npz``."""
    suffix = "" if dtype == "float32" else "_bf16"
    return Path(__file__).with_name(f"{stem}_golden{suffix}.npz")


def leaf_sum(x: np.ndarray, dtype: str) -> float:
    """The float64 sum of the float32 leaf ``x`` in ``dtype``: ``x.sum``
    in float32, else the sum over chunks of CHUNK elements, in order, of
    each chunk rounded to ``dtype`` (to nearest even) and summed in
    float64. The fixture tests recompute it with this function."""
    if dtype == "float32":
        return float(x.sum(dtype=np.float64))
    flat, total = x.reshape(-1), 0.0
    for i in range(0, flat.size, CHUNK):
        total += float(flat[i:i + CHUNK].astype(ml_dtypes.bfloat16)
                       .astype(np.float32).sum(dtype=np.float64))
    return total


def reference_dtypes(cfg) -> dict:
    """"/"-joined path -> the dtype name the reference's ``lm.init`` gives
    that leaf under ``cfg`` (abstract: nothing is allocated)."""
    shapes = jax.eval_shape(lambda: lm.init(jax.random.key(0), cfg))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out["/".join(map(str, keys))] = jnp.dtype(leaf.dtype).name
    return out


def params_of(cfg, pcfg, seed: int = SEED):
    """The recipe's tree as JAX arrays, each leaf in the reference's own
    dtype for it, converted as ``numpy_lm_leaves`` yields it; and each
    leaf's path, shape, dtype and :func:`leaf_sum`."""
    dtypes = reference_dtypes(cfg)
    tree: dict = {"segments": [None] * len(lm.segments(cfg))}
    paths, shapes, kinds, sums = [], [], [], []
    for path, x in numpy_lm_leaves(pcfg, seed):
        name = "/".join(map(str, path))
        dt = dtypes.pop(name)
        paths.append(name)
        shapes.append(x.shape)
        kinds.append(dt)
        sums.append(leaf_sum(x, dt))
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                if node[key] is None:
                    node[key] = {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = (jnp.asarray(x) if dt == "float32"
                          else jnp.asarray(x.astype(ml_dtypes.bfloat16)))
        del x
    if dtypes:
        raise AssertionError(f"the recipe lacks the reference's leaves "
                             f"{sorted(dtypes)}")
    return tree, dict(leaf_paths=np.array(paths), leaf_shapes=np.array(
        [",".join(map(str, s)) for s in shapes]), leaf_dtypes=np.array(kinds),
        leaf_sums=np.array(sums))


def summary(steps, vocab: int) -> dict:
    """The kept statistics of the logits of each step ([steps, B, V])."""
    lg = np.stack([np.asarray(s, dtype=np.float32) for s in steps])
    top = np.argsort(-lg, axis=-1, kind="stable")[..., :KEEP]
    vals = np.take_along_axis(lg, top, -1)
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1))).astype(np.float32)
    real = lg[..., :vocab]                                  # pad columns: -1e30
    rms = np.sqrt(np.square(real, dtype=np.float64).mean(-1)).astype(np.float32)
    return dict(top_idx=top.astype(np.int32), top_val=vals.astype(np.float32),
                lse=lse, rms=rms, topk=TOPK,
                min_gap=float(np.min(vals[..., :TOPK] - vals[..., 1:TOPK + 1])))


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


@contextlib.contextmanager
def recording_moe(seen: list):
    """While open, every MoE layer's input (a call of the reference's
    ``moe.apply``) is appended to ``seen`` as numpy, read out of the traced
    function with ``jax.debug.callback``."""
    apply = ref_blocks.moe_mod.apply

    def recording(p, c, x):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), x)
        return apply(p, c, x)

    ref_blocks.moe_mod.apply = recording
    try:
        yield
    finally:
        jax.effects_barrier()
        ref_blocks.moe_mod.apply = apply


def moe_routes(seen, w, cfg, name: str) -> dict:
    """The routing arrays of :func:`routing` of one call's MoE inputs
    ``seen`` (one a layer; ``w`` the stacked router weights), stacked
    over the layers under ``name``_idx, _prob, _keep and _cut_gap."""
    if len(seen) != w.shape[0]:
        raise AssertionError(f"{len(seen)} MoE inputs recorded, want "
                             f"{w.shape[0]}")
    idx, prob, keep, gap = map(np.stack, zip(*(
        routing(x, w[j], cfg) for j, x in enumerate(seen))))
    return {f"{name}_idx": idx, f"{name}_prob": prob, f"{name}_keep": keep,
            f"{name}_cut_gap": gap}


def peak_gib() -> float:
    """This process's peak resident set, GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def make(arch: str, layers: int, out: Path, dtype: str = "float32",
         prompt: int = PROMPT, routing_segment: int | None = None) -> None:
    """Write ``arch``'s golden at full width cut to ``layers`` in ``dtype``
    to ``out``; ``routing_segment`` names the MoE segment whose prefill
    and decode-step routing the file keeps too."""
    t = time.perf_counter()

    def cut(cfg):
        return dataclasses.replace(cfg, num_layers=layers, dtype=dtype)

    cfg, pcfg = cut(get_config(arch)), cut(port_config(arch))
    params, leaves = params_of(cfg, pcfg)
    print(f"weights: {time.perf_counter() - t:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, prompt + STEPS)).astype(np.int32)
    cache = lm.init_cache(cfg, BATCH, max_len=prompt + STEPS)
    seen: list = []
    calls = []                       # each call's MoE inputs, a list a layer
    with (recording_moe(seen) if routing_segment is not None
          else contextlib.nullcontext()):
        logits, cache = jax.jit(
            lambda p, t, c: lm.prefill(p, cfg, tokens=t, cache=c))(
            params, jnp.asarray(tokens[:, :prompt]), cache)
        steps = [logits]
        decode = jax.jit(lambda p, t, c, n: lm.decode_step(p, cfg, t, c, n))
        for i in range(STEPS):
            jax.effects_barrier()
            calls.append(list(seen))
            seen.clear()
            logits, cache = decode(params, jnp.asarray(tokens[:, prompt + i]),
                                   cache, jnp.int32(prompt + i))
            steps.append(logits)
    calls.append(list(seen))
    routes = {}
    if routing_segment is not None:
        w = params["segments"][routing_segment]["ffn"]["router"]["w"]
        routes = moe_routes(calls[0], w, cfg, "route")
        _, metrics = jax.jit(lambda p, t: lm.forward(p, cfg, tokens=t))(
            params, jnp.asarray(tokens[:, :prompt]))
        routes["moe_dropped"] = int((~routes["route_keep"]).sum())
        if routes["moe_dropped"] != int(metrics["moe_dropped"]):
            raise AssertionError(f"routing drops {routes['moe_dropped']}, the "
                                 f"reference's forward {metrics['moe_dropped']}")
        # Each decode step's routing ([steps, layers, B, 1, ...]); a step's
        # groups are single tokens, so its cut drops nothing.
        step_routes = [moe_routes(x, w, cfg, "step_route") for x in calls[1:]]
        for key in step_routes[0]:
            routes[key] = np.stack([r[key] for r in step_routes])
        if not routes["step_route_keep"].all():
            raise AssertionError("a decode step dropped an assignment")
    stats = summary(steps, cfg.vocab_size)
    np.savez_compressed(
        out, arch=arch, dtype=dtype, seed=SEED, layers=layers, tokens=tokens,
        prompt_len=prompt, **stats, **routes, **leaves)
    print(f"wrote {out} ({out.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s, peak RSS {peak_gib():.1f} GiB; "
          f"smallest gap between top-{TOPK} neighbours {stats['min_gap']:.3e}"
          + (f"; prefill drops {routes['moe_dropped']} of "
             f"{routes['route_keep'].size} assignments" if routes else ""),
          flush=True)


def cli(arch: str, layers: int, stem: str, argv=None, **kw) -> int:
    """A maker's command line: ``--dtype float32`` (the default) or
    ``bfloat16``."""
    ap = argparse.ArgumentParser(description=f"Write {stem}'s golden.")
    ap.add_argument("--dtype", choices=DTYPES, default="float32")
    dtype = ap.parse_args(argv).dtype
    make(arch, layers, out_path(stem, dtype), dtype, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(cli("mamba2-130m", 24, "mamba2_130m"))
