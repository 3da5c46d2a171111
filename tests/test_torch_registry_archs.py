"""The paths that gemma-2b, minicpm-2b, starcoder2-7b and dbrx-132b take on
the card, checked on the CPU against the reference package at narrow
widths, and the kernel plans and launch counts ``chip_smoke.py`` holds
their serve runs to.

* ``plan``'s body and split at each arch's serve shapes (batch 8, a
  2,048-token prompt: prefill and a decode step over the 2,080-key cache)
  and at its golden's (batch 2, a 300-token f32 prompt, 3 decode steps);
  the flash launches of a serve run and of a golden run
  (``chip_smoke.new_serve_want``): one ``mma`` a layer in the prefill, one
  ``split`` and one ``combine`` a layer and decode step.
* Kernel 5's plain version against the reference's Pallas kernel
  (``interpret`` mode on the CPU) and its ``blockwise_attention`` with
  ``kv_len`` at a group of 9 rows a kv head (starcoder2-7b's 36 over 4
  heads) and at 36-head MHA (minicpm-2b's), narrow: f32 within 2e-5 (the
  order of f32 sums), bf16 within 2e-2 (the reference's kernel-test
  tolerance); the split body's arithmetic at those groups too.
* The MoE FFN in dbrx-132b's layout (16 experts, top-4, no shared experts,
  capacity factor 1.25) at narrow width against the reference's layer on
  the same weights and input: output within 1e-5, ``moe_dropped`` equal,
  ``moe_aux`` within 1e-6.
* starcoder2-7b's smoke config with every bias and norm weight drawn
  non-zero (the recipe and the reference's initialisers make the biases
  zero and the norm weights one, so no golden sees them): ``forward``,
  ``prefill`` and every ``decode_step`` within 1e-4 of the reference's
  logits, in f32.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels import ops
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.attention import blockwise_attention as ref_blockwise
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, lm, moe

BF16 = np.dtype(jnp.bfloat16)
ARCHS = ("gemma-2b", "minicpm-2b", "starcoder2-7b", "dbrx-132b")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# arch -> (bf16 prefill, bf16 decode at the first and the last fill level
# (2,049 and 2,080 keys), f32 golden prefill, f32 golden decode at 301
# keys), each plan as (body, splits, chunk). The split targets 528 CTAs:
# ceil(528 / (B x Hkv)) chunks of whole 64-key tiles.
PLANS = {
    "gemma-2b": (("mma", 1, 0), ("split", 33, 64), ("simt", 1, 0),
                 ("split", 5, 64)),
    "minicpm-2b": (("mma", 1, 0), ("split", 2, 1088), ("simt", 1, 0),
                   ("split", 5, 64)),
    "starcoder2-7b": (("mma", 1, 0), ("split", 17, 128), ("simt", 1, 0),
                      ("split", 5, 64)),
    "dbrx-132b": (("mma", 1, 0), ("split", 9, 256), ("simt", 1, 0),
                  ("split", 5, 64)),
}
#: arch -> layers served on the card (dbrx at depth 8 of 40) and the
#: golden's depth (None: no golden).
DEPTHS = {"gemma-2b": (18, 4), "minicpm-2b": (40, 8),
          "starcoder2-7b": (32, 2), "dbrx-132b": (8, None)}


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_at_the_serve_and_golden_shapes(arch):
    cfg = get_config(arch)
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    prefill, decode, g_prefill, g_decode = PLANS[arch]
    bf16, f32 = torch.bfloat16, torch.float32
    assert tuple(fa.plan(8, 2048, 2048, h, hkv, d, bf16)) == prefill
    for n in (2049, 2080):
        assert tuple(fa.plan(8, 1, 2080, h, hkv, d, bf16, [n] * 8)) == decode
        assert tuple(fa.plan(8, 1, 2080, h, hkv, d, f32, [n] * 8)) == decode
    assert tuple(fa.plan(2, 300, 300, h, hkv, d, f32)) == g_prefill
    assert tuple(fa.plan(2, 1, 303, h, hkv, d, f32, [301] * 2)) == g_decode
    for (body, splits, chunk), keys in ((decode, 2080), (g_decode, 301)):
        assert body == "split" and chunk % 64 == 0     # every key covered
        assert splits * chunk >= keys > (splits - 1) * chunk
    # The group a decode step hands the split body: 8, 1, 9 and 6 rows.
    assert h // hkv == {"gemma-2b": 8, "minicpm-2b": 1, "starcoder2-7b": 9,
                        "dbrx-132b": 6}[arch] <= fa.SPLIT_ROWS


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_launch_counts(arch):
    """Phase 16e's counted serve (batch 8 x 2,048, 32 new tokens) and phase
    18h's golden run (2 x 300 in f32, 3 decode steps) launch what ``plan``
    gives: the table of the serve runs' ``mma`` / ``split`` / ``combine``
    launches (18 / 558 / 558, 40 / 1,240 / 1,240, 32 / 992 / 992 and 8 /
    248 / 248)."""
    cs = _chip_smoke()
    served, golden = DEPTHS[arch]
    extra = cs.REGISTRY_SERVES[arch]
    assert (int(extra[1]) if extra else get_config(arch).num_layers) == served
    cfg = dataclasses.replace(get_config(arch), num_layers=served)
    b, p, gen = (int(x) for x in cs.NEW_SERVE_ARGS[1::2])
    assert (b, p, gen) == (8, 2048, 32)
    assert cs.new_serve_want(fa, cfg, b, p, gen) == {
        "flash_attention": served * gen, "flash_attention_mma": served,
        "flash_attention_split": served * (gen - 1),
        "flash_attention_combine": served * (gen - 1),
        "flash_attention_simt": 0}
    if golden is None:
        assert arch not in cs.REGISTRY_GOLDENS
        return
    assert cs.REGISTRY_GOLDENS[arch].name == \
        f"{arch.replace('-', '_')}_golden.npz"
    g32 = dataclasses.replace(cfg, num_layers=golden, dtype="float32")
    assert cs.new_serve_want(fa, g32, 2, 300, 4) == {
        "flash_attention": golden * 4, "flash_attention_simt": golden,
        "flash_attention_split": golden * 3,
        "flash_attention_combine": golden * 3, "flash_attention_mma": 0}


def test_chip_smoke_kernel_cases_follow_the_configs():
    """The kernel checks' and timings' shapes of the four archs are their
    configs' heads at batch 8 x 2,048 (prefill) and one query over 2,080
    keys (decode), on the bodies ``plan`` gives."""
    cs = _chip_smoke()
    names = {"gemma": "gemma-2b", "minicpm": "minicpm-2b",
             "starcoder2": "starcoder2-7b", "dbrx": "dbrx-132b"}
    for name, arch in names.items():
        cfg = get_config(arch)
        for step, tq in (("prefill", 2048), ("decode", 1)):
            case = f"{name}_{step}"
            b, hq, hkv, cq, tkv, d, causal, lens, layout, bodies = \
                cs.SERVE_CASES[case]
            assert (b, hq, hkv, d) == (8, cfg.num_heads, cfg.num_kv_heads,
                                       cfg.hd)
            assert (cq, tkv) == ((2048, 2048) if tq > 1 else (1, 2080))
            assert causal and case in cs.FLASH_TIMED
            for dtype, body in zip((torch.float32, torch.bfloat16), bodies):
                assert fa.plan(b, cq, tkv, hq, hkv, d, dtype, lens).body == body


def _t(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


# (b, hq, hkv, tq, tkv, d): starcoder2-7b's group of 9 rows and minicpm-2b's
# MHA, narrow, in the Pallas kernel's layout; Tq > one 64-row block, Tkv
# not a multiple of 64.
PALLAS_CASES = {"group9": (2, 36, 4, 72, 72, 16), "mha36": (1, 36, 36, 65, 65, 8)}


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_matches_pallas_kernel(case, dtype):
    b, hq, hkv, tq, tkv, d = PALLAS_CASES[case]
    rng = np.random.default_rng(29)
    q = rng.standard_normal((b, hq, tq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, tkv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, tkv, d)).astype(dtype)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, block_q=64, block_k=64)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert got.dtype == _t(q).dtype and got.shape == (b, hq, tq, d)
    tol = 2e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# (b, hq, hkv, tkv, d, kv_len, chunk): a decode step of each group over a
# ragged cache (fill levels 1, 64, 65 and the whole), split into 64-key
# chunks as the split body cuts it.
DECODE_CASES = {"group9": (4, 36, 4, 130, 16, [1, 64, 65, 130], 64),
                "mha36": (2, 36, 36, 100, 8, [65, 100], 64)}


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_reference(case, dtype):
    """The plain version and the split body's arithmetic against the
    reference's ``blockwise_attention`` with ``kv_len``."""
    b, hq, hkv, tkv, d, kv_len, chunk = DECODE_CASES[case]
    rng = np.random.default_rng(31)
    q = rng.standard_normal((b, 1, hq, d)).astype(dtype)
    k = rng.standard_normal((b, tkv, hkv, d)).astype(dtype)
    v = rng.standard_normal((b, tkv, hkv, d)).astype(dtype)
    want = np.asarray(ref_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=16, kv_chunk=32, kv_len=jnp.asarray(kv_len, jnp.int32)),
        np.float32)
    tol = 2e-5 if dtype == np.float32 else 2e-2
    for got in (fa.attention(_t(q), _t(k), _t(v), causal=True, kv_len=kv_len),
                fa.attention_split_plain(_t(q), _t(k), _t(v), causal=True,
                                         kv_len=kv_len, chunk=chunk)):
        assert got.dtype == _t(q).dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def _dbrx_moe(cfg_fn, d=32):
    """dbrx-132b's MoE layout at narrow width (d_model 32, experts of 48)."""
    cfg = cfg_fn("dbrx-132b")
    m = dataclasses.replace(cfg.moe, d_ff_expert=48)
    return dataclasses.replace(cfg, d_model=d, num_layers=1, dtype="float32",
                               moe=m)


def test_dbrx_moe_layout_matches_reference():
    cfg, rcfg = _dbrx_moe(get_config), _dbrx_moe(ref_config)
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.num_shared, m.capacity_factor,
            m.dispatch_order) == (16, 4, 0, 1.25, "criticality")
    assert rcfg.moe == ref_common.MoECfg(**dataclasses.asdict(m))
    params = ref_moe.init(jax.random.key(3), rcfg)
    x = np.random.default_rng(7).standard_normal((3, 40, 32)).astype(np.float32)
    want, wm = ref_moe.apply(params, rcfg, jnp.asarray(x))
    mod = moe.MoE(cfg, device="cpu")
    mod.load_state_dict({name: torch.from_numpy(np.array(leaf)) for name, leaf
                         in convert._flatten(jax.tree.map(np.asarray, params))},
                        strict=True)
    assert mod.shared is None
    got, gm = moe.apply(mod, cfg, torch.from_numpy(x))
    # 40 tokens x 4 of 16 experts at 1.25: 13 slots an expert and group,
    # and the router's draw leaves some experts over them.
    assert moe.capacity(cfg, 40) == 13
    assert float(gm["moe_dropped"]) == float(wm["moe_dropped"]) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(gm["moe_aux"]), float(wm["moe_aux"]),
                               rtol=1e-6, atol=1e-6)


def _nonzero(tree, rng):
    """The tree with every bias drawn from N(0, 0.5) and every norm weight
    from 1 + N(0, 0.2) (paths ending in ``/b``, or ``/w`` under a norm)."""
    def draw(path, x):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[-1] == "b":
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if keys[-1] == "w" and any(k in ("ln1", "ln2", "final_norm")
                                   for k in keys):
            return (1 + rng.normal(0, 0.2, x.shape)).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(draw, tree)


def test_starcoder2_biases_and_layernorm_match_reference():
    arch = "starcoder2-7b"
    cfg, rcfg = get_config(arch, smoke=True), ref_config(arch, smoke=True)
    assert (cfg.norm, cfg.qkv_bias, cfg.proj_bias, cfg.mlp_glu, cfg.act) == \
        ("layernorm", True, True, False, "gelu")
    tree = _nonzero(jax.tree.map(np.asarray, ref_lm.init(jax.random.key(2),
                                                         rcfg)),
                    np.random.default_rng(5))
    n_bias = sum(1 for path, _ in jax.tree_util.tree_leaves_with_path(tree)
                 if getattr(path[-1], "key", None) == "b")
    assert n_bias == 9   # q, k, v, o, up, down, ln1, ln2 (stacked), final norm
    params = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    b, t, p = 2, 12, 9
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    tol = dict(rtol=1e-4, atol=1e-4)
    h, _ = ref_lm.forward(params, rcfg, tokens=jnp.asarray(toks))
    th, _ = lm.forward(model, cfg, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(lm.logits_fn(model, cfg, th).numpy(),
                               np.asarray(ref_lm.logits_fn(params, rcfg, h)),
                               **tol)
    cache = ref_lm.init_cache(rcfg, b, max_len=t)
    tcache = lm.init_cache(cfg, b, max_len=t, device="cpu")
    lg, cache = ref_lm.prefill(params, rcfg, tokens=jnp.asarray(toks[:, :p]),
                               cache=cache)
    tlg, tcache = lm.prefill(model, cfg, tokens=torch.from_numpy(toks[:, :p]),
                             cache=tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **tol)
    for i in range(p, t):
        lg, cache = ref_lm.decode_step(params, rcfg, jnp.asarray(toks[:, i]),
                                       cache, jnp.int32(i))
        tlg, tcache = lm.decode_step(model, cfg, torch.from_numpy(toks[:, i]),
                                     tcache, i)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **tol)


def test_gelu_is_the_references():
    """``act="gelu"`` (gemma-2b's GeGLU, starcoder2-7b's MLP) is
    ``jax.nn.gelu``'s default, the tanh form, in both dtypes."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = common.act_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want16 = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got16 = common.act_fn("gelu")(torch.from_numpy(x).bfloat16()).float()
    np.testing.assert_allclose(got16.numpy(), want16, rtol=2e-2, atol=2e-2)
