"""The flash-attention kernel's plain version against the reference: the
Pallas kernel (``repro.kernels.ops.flash_attention``, interpret mode on the
CPU) in its [B, H, T, D] layout, and the model stack's
``repro.models.attention.blockwise_attention`` with ``kv_len``; the wrapper's
CPU routing, input checks and launch counter. The kernel itself runs only on
a card: see ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models.attention import blockwise_attention as ref_blockwise
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import blockwise_attention

BF16 = np.dtype(jnp.bfloat16)


def _t(a):
    """numpy (float32 or bfloat16) -> torch of the same dtype, exactly."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.float().numpy()


# The reference's own kernel-test shapes (tests/test_kernels.py).
@pytest.mark.parametrize(
    "b,hq,hkv,tq,tkv,d,causal,dtype",
    [
        (2, 4, 2, 128, 128, 64, True, np.float32),
        (1, 2, 1, 64, 256, 128, True, np.float32),
        (1, 4, 4, 128, 128, 80, False, np.float32),
        (2, 2, 2, 96, 160, 64, True, np.float32),
        (1, 2, 2, 128, 128, 64, True, BF16),
    ],
)
def test_plain_matches_pallas_kernel(b, hq, hkv, tq, tkv, d, causal, dtype):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, hq, tq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, tkv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, tkv, d)).astype(dtype)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=64, block_k=64)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == _t(q).dtype and got.shape == (b, hq, tq, d)
    tol = 2e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (b, tq, tkv, hq, hkv, d, causal, kv_len): decode with ragged cache fill
# levels, rep-7 GQA (qwen2-0.5b's 14 over 2 heads), MQA, non-causal.
BLOCKWISE_CASES = {
    "decode_ragged": (3, 1, 50, 14, 2, 64, True, [1, 50, 23]),
    "decode_uniform": (2, 1, 40, 4, 2, 32, True, 17),
    "prefill_rep7": (2, 40, 40, 14, 2, 16, True, None),
    "mqa_kv_len": (2, 8, 40, 4, 1, 32, True, [8, 40]),
    "mqa_decode": (2, 1, 33, 8, 1, 256, True, [5, 33]),
    "noncausal_kv_len": (2, 5, 30, 4, 2, 16, False, [3, 30]),
    "noncausal_full": (1, 12, 20, 6, 3, 80, False, None),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE_CASES))
def test_plain_matches_blockwise_attention(case):
    b, tq, tkv, hq, hkv, d, causal, kv_len = BLOCKWISE_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tkv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tkv, hkv, d)).astype(np.float32)
    ref_len = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want = ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, q_chunk=16, kv_chunk=16,
                         kv_len=ref_len)
    fa.reset_launches()
    got = blockwise_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=16,
                              kv_chunk=16, kv_len=kv_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert fa.launches["flash_attention"] == 0     # the CPU runs the plain version


def test_plain_chunking_and_layouts_agree():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 9, 6, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 70, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 70, 2, 32)).astype(np.float32))
    one = fa.attention_plain(q, k, v, kv_len=[9, 61], kv_chunk=1024)
    many = fa.attention_plain(q, k, v, kv_len=torch.tensor([9, 61]), kv_chunk=8)
    torch.testing.assert_close(one, many, rtol=1e-6, atol=1e-6)
    # The Pallas layout is the same function on transposed views.
    heads = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), kv_len=[9, 61])
    torch.testing.assert_close(heads.transpose(1, 2), one, rtol=0, atol=0)


def test_wrapper_checks():
    q = torch.zeros(2, 5, 4, 16)
    k = torch.zeros(2, 40, 2, 16)
    with pytest.raises(ValueError, match="kv_len >= Tq"):
        fa.attention(q, k, k, causal=True, kv_len=[4, 40])
    fa.attention(q, k, k, causal=False, kv_len=[4, 40])     # fine without causal
    for bad in (0, 41, [1, 2, 3]):
        with pytest.raises(ValueError):
            fa.attention(q, k, k, causal=False, kv_len=bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.attention(q, k.to(torch.bfloat16), k, causal=True)
    with pytest.raises(ValueError, match="multiple"):
        fa.attention(torch.zeros(2, 5, 3, 16), k, k, causal=True)
    # The training form takes the same inputs and computes the same
    # function, with a gradient; the kernel itself still refuses one.
    gen = torch.Generator().manual_seed(0)
    qr, kr = (torch.randn(x.shape, generator=gen) for x in (q, k))
    qr.requires_grad_()
    got = blockwise_attention(qr, kr, kr, differentiable=True, q_chunk=2,
                              kv_chunk=16, kv_len=[5, 40])
    with torch.no_grad():
        want = fa.attention(qr, kr, kr, kv_len=[5, 40])
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-6)
    got.sum().backward()
    assert qr.grad.shape == q.shape and torch.isfinite(qr.grad).all()
    with pytest.raises(NotImplementedError, match="backward"):
        fa.attention(q.requires_grad_(), k, k)


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tq", [8, 33, 64])
def test_mla_head_dim_192_matches_reference(tq, dtype):
    """MLA's prefill form at head_dim 192 (q and k [nope 128, rope 64], v's
    128 columns zero-padded to 192, ``scale = 192 ** -0.5``, causal, Tq =
    Tkv): the plain version and the split body's arithmetic against the
    reference's blockwise attention; the padded columns come out zero."""
    b, h, d, dv = 2, 4, 192, 128
    rng = np.random.default_rng(tq)
    q = rng.standard_normal((b, tq, h, d)).astype(dtype)
    k = rng.standard_normal((b, tq, h, d)).astype(dtype)
    v = rng.standard_normal((b, tq, h, d)).astype(dtype)
    v[..., dv:] = 0
    scale = d ** -0.5
    want = np.asarray(ref_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, scale=scale,
                                    q_chunk=16, kv_chunk=16), np.float32)
    tol = 2e-5 if dtype == np.float32 else 2e-2
    got = fa.attention_plain(_t(q), _t(k), _t(v), causal=True, scale=scale)
    split = fa.attention_split_plain(_t(q), _t(k), _t(v), causal=True,
                                     scale=scale, chunk=64)
    for out in (got, split):
        assert out.dtype == _t(q).dtype and out.shape == (b, tq, h, d)
        np.testing.assert_allclose(_np(out), want, rtol=tol, atol=tol)
        assert (_np(out)[..., dv:] == 0).all()
    assert tuple(fa.plan(b, tq, tq, h, h, d, _t(q).dtype, None))[0] == (
        "split" if tq <= fa.SPLIT_ROWS else
        "mma" if dtype == BF16 else "simt")


# (b, tq, tkv, hq, hkv, d, causal, kv_len, chunk): the split body's
# arithmetic with ragged kv_len at 1 and at chunk edges (64, 65, 128, 129),
# rep-7 GQA, MQA, two causal rows per position, and non-causal.
SPLIT_CASES = {
    "decode_edges_rep7": (4, 1, 200, 14, 2, 64, True, [1, 64, 65, 200], 64),
    "decode_chunk128": (3, 1, 300, 14, 2, 32, True, [1, 128, 129], 128),
    "mqa_decode_d80": (2, 1, 150, 8, 1, 80, True, [64, 150], 64),
    "tq2_rep7": (2, 2, 140, 14, 2, 16, True, [2, 140], 64),
    "noncausal": (2, 3, 130, 4, 2, 16, False, [1, 130], 64),
}


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plain_matches_reference(case, dtype):
    """Partial (m, l, acc) per key range, then the combine, against the
    reference's blockwise attention with kv_len and the unsplit plain
    version."""
    b, tq, tkv, hq, hkv, d, causal, kv_len, chunk = SPLIT_CASES[case]
    rng = np.random.default_rng(17)
    q = rng.standard_normal((b, tq, hq, d)).astype(dtype)
    k = rng.standard_normal((b, tkv, hkv, d)).astype(dtype)
    v = rng.standard_normal((b, tkv, hkv, d)).astype(dtype)
    want = ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, q_chunk=16, kv_chunk=32,
                         kv_len=jnp.asarray(kv_len, jnp.int32))
    got = fa.attention_split_plain(_t(q), _t(k), _t(v), causal=causal,
                                   kv_len=kv_len, chunk=chunk)
    unsplit = fa.attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                 kv_len=kv_len)
    assert got.dtype == _t(q).dtype and got.shape == (b, tq, hq, d)
    tol = 2e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(unsplit), rtol=tol, atol=tol)


# (b, tq, tkv, hq, hkv, d, dtype, lens) -> the plan. qwen2-0.5b's serve
# shapes (batch 8, 14 over 2 heads of 64: prefill of 2048 tokens, decode
# over the 2080-key cache at its first and last fill levels: 33 chunks of
# 64 keys, 528 CTAs) in both dtypes, one sequence's decode, a short cache
# of a 4-sequence batch, the 16-row edge and head_dim 256.
PLAN_CASES = {
    "qwen2_prefill_bf16": ((8, 2048, 2048, 14, 2, 64, "bf16", None),
                           ("mma", 1, 0)),
    "qwen2_decode_bf16": ((8, 1, 2080, 14, 2, 64, "bf16", [2080] * 8),
                          ("split", 33, 64)),
    "qwen2_decode_first_step": ((8, 1, 2080, 14, 2, 64, "bf16", [2049] * 8),
                                ("split", 33, 64)),
    "qwen2_prefill_f32": ((8, 2048, 2048, 14, 2, 64, "f32", None),
                          ("simt", 1, 0)),
    "qwen2_decode_f32": ((8, 1, 2080, 14, 2, 64, "f32", [2080] * 8),
                         ("split", 33, 64)),
    "one_sequence_decode": ((1, 1, 2080, 14, 2, 64, "bf16", [2080]),
                            ("split", 33, 64)),
    "short_cache": ((4, 1, 1000, 14, 2, 64, "bf16", [1000] * 4),
                    ("split", 16, 64)),
    "rows_16_split": ((2, 2, 300, 16, 2, 64, "bf16", [2, 300]),
                      ("split", 5, 64)),
    "rows_21_mma": ((2, 3, 300, 14, 2, 64, "bf16", [3, 300]),
                    ("mma", 1, 0)),
    "gemma_prefill_d256": ((2, 256, 256, 8, 1, 256, "bf16", None),
                           ("mma", 1, 0)),
    # deepseek-v2-lite's MLA prefill (16 heads, rep 1, head_dim 192): the
    # serve shape on the tensor cores, in f32 on simt, an 8-token prompt
    # (8 rows a head) split.
    "deepseek_prefill_d192": ((8, 2048, 2048, 16, 16, 192, "bf16", None),
                              ("mma", 1, 0)),
    "deepseek_prefill_f32": ((8, 2048, 2048, 16, 16, 192, "f32", None),
                             ("simt", 1, 0)),
    "deepseek_prompt8": ((8, 8, 8, 16, 16, 192, "bf16", [8] * 8),
                         ("split", 1, 64)),
    # zamba2-7b's shared attention (32 heads of 112, rep 1) and qwen2-vl-72b's
    # (64 q over 8 kv heads of 128): their serve prefill on the tensor cores,
    # a decode step (1 and 8 rows a kv head) split over the keys.
    "zamba2_prefill_d112": ((8, 2048, 2048, 32, 32, 112, "bf16", None),
                            ("mma", 1, 0)),
    "zamba2_decode_d112": ((8, 1, 2080, 32, 32, 112, "bf16", [2080] * 8),
                           ("split", 3, 704)),
    "qwen2vl_prefill": ((8, 2048, 2048, 64, 8, 128, "bf16", None),
                        ("mma", 1, 0)),
    "qwen2vl_decode": ((8, 1, 2080, 64, 8, 128, "bf16", [2080] * 8),
                       ("split", 9, 256)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan(case):
    (b, tq, tkv, hq, hkv, d, dt, lens), want = PLAN_CASES[case]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    got = fa.plan(b, tq, tkv, hq, hkv, d, dtype, lens)
    assert tuple(got) == want
    if got.body == "split":     # every key covered; the card filled where
        assert got.chunk % 64 == 0 and got.splits * got.chunk >= max(lens)
        assert (got.splits - 1) * got.chunk < max(lens)   # the keys allow
        assert b * hkv * got.splits >= 132 or got.chunk == 64


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-vl-72b"])
def test_serve_layouts_pass_the_kernel_checks(arch):
    """The q, k and v the attention layer hands the kernel at full width
    (zamba2's head_dim 112, qwen2-vl's 64 / 8 heads under M-RoPE), in the
    prefill (views of the rotated projections) and in decode (an entry of
    the segment-stacked cache): D contiguous, every other stride a multiple
    of 8 elements, 16-byte aligned."""
    from repro_torch.configs import get_config
    from repro_torch.models import common, lm

    cfg = get_config(arch)
    b, t, h, hkv, d = 1, 3, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    x = torch.zeros(b, t, cfg.d_model, dtype=torch.bfloat16)
    q = (x @ torch.zeros(cfg.d_model, h * d, dtype=x.dtype)).reshape(b, t, h, d)
    k = (x @ torch.zeros(cfg.d_model, hkv * d, dtype=x.dtype)).reshape(b, t, hkv, d)
    pos = lm.make_positions(cfg, b, t)
    rot = common.apply_mrope if cfg.pos == "mrope" else common.apply_rope
    q, k = (rot(y.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
            for y in (q, k))
    fa._check_layout(q, k, k)
    cache = torch.zeros(3, b, 8, hkv, d, dtype=x.dtype)       # [n, b, L, ...]
    fa._check_layout(q[:, :1], cache[1], cache[2])


def test_launch_rejects_bad_plans():
    q = torch.zeros(2, 5, 4, 16)
    k = torch.zeros(2, 40, 2, 16)
    with pytest.raises(ValueError, match="mma body does not take"):
        fa.launch(q, k, k, fa.Plan("mma"), causal=True, scale=None,
                  lens=[40, 40])
    with pytest.raises(ValueError, match="simt body does not take"):
        fa.launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), fa.Plan("simt"),
                  causal=True, scale=None, lens=[40, 40])
    with pytest.raises(ValueError, match="no split plan"):   # chunk of 32
        fa.launch(q, k, k, fa.Plan("split", 2, 32), causal=True, scale=None,
                  lens=[40, 40])
    with pytest.raises(ValueError, match="no split plan"):   # keys past the chunks
        fa.launch(q[:, :1], k, k, fa.Plan("split", 1, 0), causal=True,
                  scale=None, lens=[40, 40])
    with pytest.raises(ValueError, match="no split plan"):   # 20 rows
        fa.launch(torch.zeros(2, 10, 4, 16), k, k, fa.Plan("split", 1, 64),
                  causal=True, scale=None, lens=[40, 40])
