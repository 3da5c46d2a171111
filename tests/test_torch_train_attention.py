"""The port's training form of attention (``blockwise_attention(...,
differentiable=True)``, torch ops under autograd) against the reference's
``differentiable=True`` form under ``jax.vjp``, on the CPU.

Each case draws q, k, v and the output's cotangent from a numpy seed; both
sides give the output and the gradients of q, k and v. Causal and
non-causal, GQA and MQA, ragged Tq and Tkv (neither a multiple of its
chunk), several q and kv chunks, and ``kv_len``. Tolerance: float32 1e-5
relative and absolute; bfloat16 inputs (f32 accumulation, the output and
the gradients rounded to bfloat16) 2e-2. Also: the dispatch of a mode
``"train"`` forward (the training form exactly when gradients are
enabled, the kernel under ``torch.no_grad()``), and the training form
against the kernel's plain version.
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention

#: name: (b, tq, tkv, hq, hkv, d, causal, kv_len, q_chunk, kv_chunk, dtype)
CASES = {
    "causal_gqa_chunks": (2, 16, 16, 4, 2, 8, True, None, 8, 8, "float32"),
    "causal_ragged_kv_len": (2, 13, 29, 4, 1, 8, True, [20, 29], 4, 8,
                             "float32"),
    "causal_q_chunk_below_kv": (1, 33, 33, 4, 2, 8, True, None, 8, 16,
                                "float32"),
    "causal_one_chunk": (2, 9, 9, 2, 2, 16, True, None, 512, 1024, "float32"),
    "noncausal_ragged": (1, 12, 40, 2, 2, 16, False, None, 5, 16, "float32"),
    "noncausal_kv_len": (2, 7, 7, 6, 3, 8, False, [3, 7], 32, 32, "float32"),
    "noncausal_cross": (2, 10, 21, 4, 4, 8, False, None, 4, 8, "float32"),
    "causal_bf16": (2, 16, 24, 4, 2, 16, True, None, 8, 8, "bfloat16"),
}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(case):
    b, tq, tkv, hq, hkv, d, *_ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, tq, hq, d), (b, tkv, hkv, d), (b, tkv, hkv, d),
                      (b, tq, hq, d))]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "train_attention", f"""
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
from test_torch_train_attention import CASES, _inputs
from repro.models.attention import blockwise_attention

for case, (b, tq, tkv, hq, hkv, d, causal, kv_len, qc, kc, dt) in CASES.items():
    q, k, v, ct = (jnp.asarray(x).astype(dt) for x in _inputs(case))
    lens = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    f = lambda q, k, v: blockwise_attention(
        q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc, kv_len=lens,
        differentiable=True)
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    for name, x in zip(("out", "dq", "dk", "dv"), (out, *vjp(ct))):
        res[f"{{case}}/{{name}}"] = np.asarray(x.astype(jnp.float32))
""")


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_form_matches_reference(reference, case):
    *_, causal, kv_len, qc, kc, dt = CASES[case]
    dtype = getattr(torch, dt)
    q, k, v, ct = (torch.from_numpy(x).to(dtype) for x in _inputs(case))
    for x in (q, k, v):
        x.requires_grad_()
    out = attention.blockwise_attention(q, k, v, causal=causal, q_chunk=qc,
                                        kv_chunk=kc, kv_len=kv_len,
                                        differentiable=True)
    assert out.dtype == dtype and out.shape == q.shape
    grads = torch.autograd.grad(out, (q, k, v), ct)
    for name, got in zip(("out", "dq", "dk", "dv"), (out, *grads)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   reference[f"{case}/{name}"], **TOL[dt],
                                   err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", [c for c in sorted(CASES)
                                  if CASES[c][-1] == "float32"])
def test_training_form_equals_the_kernels_plain_version(case):
    """The same function as the kernel's plain version (the serve form on
    the CPU), within 1e-5."""
    *_, causal, kv_len, qc, kc, _ = CASES[case]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case))
    got = attention.train_attention(q, k, v, causal=causal, q_chunk=qc,
                                    kv_chunk=kc, kv_len=kv_len)
    want = fa.attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_mode_dispatch(monkeypatch):
    """A mode ``"train"`` forward takes the training form exactly when
    gradients are enabled: an attention layer's call under
    ``torch.no_grad()`` reaches the kernel's wrapper, with gradients the
    training form; the kernel refuses a tensor that needs a gradient."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    calls = []
    for mod, name in ((attention, "train_attention"), (fa, "attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    cfg = get_config("qwen2-0.5b", smoke=True)
    layer = blocks.Attention(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    aux = {"mode": "train", "positions": torch.arange(5).expand(2, 5)}
    with torch.no_grad():
        served, _ = layer(x, aux)
    assert calls == ["attention"]
    layer.requires_grad_(True)
    trained, _ = layer(x, aux)
    assert calls == ["attention", "train_attention"] and trained.requires_grad
    torch.testing.assert_close(trained.detach(), served, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="differentiable form"):
        fa.attention(x.reshape(2, 5, 4, 16).requires_grad_(),
                     x.reshape(2, 5, 4, 16), x.reshape(2, 5, 4, 16))
