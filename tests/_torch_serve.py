"""Shared pieces of the sharded serve tests (``repro_torch.train.sharded``'s
``make_sharded_prefill_step`` and ``make_sharded_decode_step``): the cases,
their weights and inputs, the one-device run they are held to, and the body
that runs them on gloo ranks (``_torch_ref.run_ranks``).

Each case is a smoke config in float32 with the numpy recipe's weights
(``convert.numpy_lm_params(cfg, 0)``), a batch of ``B`` rows of ``P``
prompt tokens (a VLM's stub embeddings; whisper's ``2 P`` frames before its
tokens) from ``default_rng(0)``, a prefill and ``GEN - 1`` greedy decode
steps into a cache of ``P + GEN`` positions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.train.steps import make_decode_step, make_prefill_step

#: name -> arch (smoke config): dense, MoE with MLA, the hybrid (Mamba2
#: with a shared attention block), the encoder-decoder.
CASES = {"dense": "qwen2-0.5b", "moe": "deepseek-v2-lite-16b",
         "hybrid": "zamba2-7b", "encdec": "whisper-large-v3"}
#: Also on the 1x1 mesh: the VLM's embeddings and the pure SSM.
ONE_RANK_CASES = {**CASES, "vlm": "qwen2-vl-72b", "ssm": "mamba2-130m"}
B, P, GEN = 8, 9, 3


def config(case: str, module=None):
    """The case's smoke config (the port's, or ``module``'s
    ``get_config``)."""
    return (module or get_config)(ONE_RANK_CASES[case], smoke=True)


def inputs(cfg) -> dict:
    """The global batch as numpy arrays."""
    rng = np.random.default_rng(0)
    if cfg.encdec is not None:
        frames = rng.standard_normal((B, 2 * P, cfg.d_model))
        return {"frames": frames.astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (B, P)).astype(np.int32)}
    if cfg.family == "vlm":
        return {"embeds": rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)}


def model(cfg):
    """The numpy recipe's weights as the port's one-device model."""
    return convert.lm_params_from_numpy(cfg, convert.numpy_lm_params(cfg, 0),
                                        device="cpu")


def one_device_cache(cfg):
    if cfg.encdec is not None:
        return lm.encdec_init_cache(cfg, B, P + GEN, 2 * P, device="cpu")
    return lm.init_cache(cfg, B, P + GEN, device="cpu")


def flat_cache(cache) -> list:
    """The cache's leaves in a fixed order (segments, then names)."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in flat_cache(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [x for v in cache for x in flat_cache(v)]
    return [cache]


def run_one_device(case: str) -> dict:
    """The one-device steps: ``logits/i`` and ``tokens/i`` of the prefill
    (i = 0) and each decode step, and ``cache/j`` the final cache's
    leaves."""
    cfg = config(case)
    params = model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg).items()}
    logits, cache = make_prefill_step(cfg)(params, batch, one_device_cache(cfg))
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = {"logits/0": logits.numpy(), "tokens/0": tok.numpy()}
    decode = make_decode_step(cfg)
    for i in range(1, GEN):
        tok, logits, cache = decode(params, tok, cache, P + i - 1)
        out[f"logits/{i}"] = logits.numpy()
        out[f"tokens/{i}"] = tok.numpy()
    for j, leaf in enumerate(flat_cache(cache)):
        out[f"cache/{j}"] = leaf.numpy()
    return out


def run_sharded(case: str, mesh) -> dict:
    """The sharded steps on ``mesh`` from the same weights and batch: the
    rank's rows' ``logits/i`` and ``tokens/i``, ``rows`` (first row,
    count), and for each cache leaf its local block ``cache/j`` and the
    block's first index in each dim ``at/j``."""
    from repro_torch.distributed import sharding
    from repro_torch.train import sharded

    cfg = config(case)
    params = sharded.shard_params(cfg, model(cfg), mesh)
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg).items()}
    rows = sharded.serve_rows(batch, mesh)
    r, n = sharding.data_index(mesh)
    count = next(iter(rows.values())).shape[0]
    cache = sharded.init_cache(cfg, B, P + GEN, mesh, enc_len=2 * P,
                               device="cpu")
    logits, cache = sharded.make_sharded_prefill_step(cfg, mesh)(
        params, rows, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = {"logits/0": logits.numpy(), "tokens/0": tok.numpy(),
           "rows": np.array([r * count if count < B else 0, count])}
    decode = sharded.make_sharded_decode_step(cfg, mesh)
    for i in range(1, GEN):
        tok, logits, cache = decode(params, tok, cache, P + i - 1)
        out[f"logits/{i}"] = logits.numpy()
        out[f"tokens/{i}"] = tok.numpy()
    for j, leaf in enumerate(flat_cache(cache)):
        shd = sharding.Sharding(leaf.device_mesh, None, tuple(leaf.placements))
        out[f"cache/{j}"] = leaf.to_local().numpy()
        out[f"at/{j}"] = np.array([s for s, _ in sharding._block(leaf.shape,
                                                                 shd)])
    return out


#: The body of :func:`_torch_ref.run_ranks`: every case of :data:`CASES` on
#: the mesh ``MESH``, saved under ``<case>/``.
RANK_BODY = """
import sys
sys.path.insert(0, "tests")
import _torch_serve as S

mesh = mesh_of(MESH)
for case in S.CASES:
    for k, v in S.run_sharded(case, mesh).items():
        res[f"{case}/{k}"] = v
"""


def case_of(res: dict, case: str) -> dict:
    prefix = f"{case}/"
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def block_of(whole: np.ndarray, at: np.ndarray, like: np.ndarray):
    """The block of ``whole`` starting at ``at`` of ``like``'s shape."""
    return whole[tuple(slice(a, a + n) for a, n in zip(at, like.shape))]


def assert_rank_matches(got: dict, want: dict, *, exact: bool, tol=None,
                        label=""):
    """A rank's rows and cache blocks against the one-device run: bit for
    bit, or within ``tol`` (relative to each tensor's largest magnitude);
    the tokens equal either way."""
    start, count = (int(x) for x in got["rows"])
    rows = slice(start, start + count)

    def check(g, w, name):
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
        else:
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=f"{label} {name}")

    for i in range(GEN):
        check(got[f"logits/{i}"], want[f"logits/{i}"][rows], f"logits/{i}")
        np.testing.assert_array_equal(got[f"tokens/{i}"],
                                      want[f"tokens/{i}"][rows],
                                      err_msg=f"{label} tokens/{i}")
    leaves = sorted(int(k[6:]) for k in got if k.startswith("cache/"))
    assert leaves == sorted(int(k[6:]) for k in want if k.startswith("cache/"))
    for j in leaves:
        g = got[f"cache/{j}"]
        check(g, block_of(want[f"cache/{j}"], got[f"at/{j}"], g), f"cache/{j}")
