"""Write ``qwen2_0_5b_train_golden.npz``: one training step of the reference
package on qwen2-0.5b at full width and depth, float32, the golden that
``chip_smoke.py`` (phase 20b) holds the port's training against on the card,
and the same at depth 2, which the CPU tests hold the port against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_qwen2_0_5b_train_golden.py

The reference (``repro.train.steps.make_loss_fn``, ``repro.optim.AdamW``)
takes qwen2-0.5b's full config in float32 (24 layers, d_model 896, 14 q over
2 kv heads of 64, QKV bias, tied embeddings, vocab 151936; remat on) with
the weights of ``repro_torch.convert.numpy_lm_params(cfg, seed=0)``, and
the batch ``SyntheticCopyTask(vocab, batch=2, seq=64, seed=0).batch_at(0)``
(63 tokens a row, the copied half scored). It keeps the loss and its
metrics (``xent``, ``accuracy``, ``tokens``), the gradient's global norm
(AdamW's ``grad_norm``, before clipping) and each leaf's gradient norm
(float64, in the reference's tree: a segment's leaf stacked over its
layers), and for a few leaves (``SLICES``) the gradient, the weight and the
weight after one step of ``AdamW(lr=1e-3)`` (its defaults: b2 0.95, weight
decay 0.1, clipping at 1.0, master weights) at fixed flat indices (embed:
in the rows of the batch's tokens), with each weight leaf's float64 sum (so
a test can check that the recipe still makes these weights) and the batch's
tokens (``batch_tokens``). The ``small_*`` arrays are the same at depth 2. The reference
imports ``enable_x64`` from ``jax.experimental``, which newer jax lacks, so
this script aliases it to ``jax.enable_x64`` first. Takes ~2 minutes and
~8 GB on the CPU.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.experimental

jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import SyntheticCopyTask  # noqa: E402
from repro.optim import AdamW  # noqa: E402
from repro.train.steps import make_loss_fn  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import numpy_lm_leaves  # noqa: E402

ARCH, SEED, BATCH, SEQ, LR, SMALL = "qwen2-0.5b", 0, 2, 64, 1e-3, 2
#: Leaves whose values are kept at ``PER_SLICE`` fixed flat indices.
SLICES = ("embed", "segments/0/attn/wq/w", "segments/0/attn/wv/b",
          "segments/0/ffn/w_down/w", "segments/0/ln1/w", "final_norm/w")
PER_SLICE = 48
OUT = Path(__file__).with_name("qwen2_0_5b_train_golden.npz")


def cut(cfg, layers):
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32")


def batch(vocab: int) -> dict:
    return SyntheticCopyTask(vocab, batch=BATCH, seq=SEQ, seed=SEED).batch_at(0)


def slice_index(path: str, shape, tokens) -> np.ndarray:
    """``PER_SLICE`` flat indices into a leaf of ``shape``, fixed by the
    path; for ``embed``, in the rows of the batch's first tokens."""
    rng = np.random.default_rng([SEED, SLICES.index(path)])
    if path == "embed":
        rows = np.unique(tokens)[:PER_SLICE]
        rows = rows[rng.integers(0, len(rows), PER_SLICE)]
        cols = rng.integers(0, shape[1], PER_SLICE)
        return np.ravel_multi_index((rows, cols), shape)
    return np.sort(rng.choice(int(np.prod(shape)), PER_SLICE, replace=False))


def flat(tree, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def run(layers: int, prefix: str) -> dict:
    t = time.perf_counter()
    cfg = cut(get_config(ARCH), layers)
    pcfg = cut(port_config(ARCH), layers)
    tree: dict = {"segments": [{}]}
    sums = {}
    for path, x in numpy_lm_leaves(pcfg, SEED):
        key = "/".join(map(str, path))
        sums[key] = x.sum(dtype=np.float64)
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(x)
    b = batch(cfg.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(cfg), has_aux=True))(tree, {k: jnp.asarray(v)
                                                 for k, v in b.items()})
    g, p = flat(grads), flat(tree)
    idx = {s: slice_index(s, p[s].shape, b["tokens"]) for s in SLICES}
    opt = AdamW(lr=LR)

    def step(params, grads):
        new, _, om = opt.update(grads, opt.init(params), params)
        new = flat(new)
        return {s: new[s].reshape(-1)[idx[s]] for s in SLICES}, om

    new, om = jax.jit(step)(tree, grads)
    out = {"loss": loss, "grad_norm": om["grad_norm"],
           **{k: metrics[k] for k in ("xent", "accuracy", "tokens")},
           "leaf_paths": np.array(sorted(g)),
           "leaf_grad_norms": np.array([np.sqrt(np.square(
               np.asarray(g[k], np.float64)).sum()) for k in sorted(g)]),
           "weight_paths": np.array(list(sums)),
           "weight_sums": np.array(list(sums.values()))}
    for s in SLICES:
        out[f"idx/{s}"] = idx[s]
        out[f"grad/{s}"] = np.asarray(g[s]).reshape(-1)[idx[s]]
        out[f"param/{s}"] = np.asarray(p[s]).reshape(-1)[idx[s]]
        out[f"new/{s}"] = new[s]
    print(f"depth {layers}: loss {float(loss):.6f}, grad_norm "
          f"{float(om['grad_norm']):.6f}, {time.perf_counter() - t:.1f} s",
          flush=True)
    return {prefix + k: np.asarray(v) for k, v in out.items()}


def main() -> int:
    t = time.perf_counter()
    cfg = get_config(ARCH)
    res = {"arch": np.array(ARCH), "seed": SEED, "batch": BATCH, "seq": SEQ,
           "lr": LR, "layers": cfg.num_layers, "small_layers": SMALL,
           "slices": np.array(SLICES),
           "batch_tokens": batch(cfg.vocab_size)["tokens"]}
    res.update(run(SMALL, "small_"))
    res.update(run(cfg.num_layers, ""))
    np.savez_compressed(OUT, **res)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
