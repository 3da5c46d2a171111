"""The port's LM serving path against the reference package's, on the CPU.

For each served smoke config (the dense family; the MoE family:
deepseek-v2-lite with MLA, dbrx with GQA; the VLM with M-RoPE, fed tokens
here; the SSM and hybrid families; whisper, whose decoder stack alone runs
``forward``, ``prefill`` and ``decode_step`` with sinusoidal positions and
whose serve steps encode frames) the reference's own weights
(``lm.init``) go through ``convert.lm_params_from_numpy``; ``forward`` (with
its MoE metrics), ``prefill`` and every ``decode_step`` must give the
reference's logits (f32, rtol = atol = 1e-4), and greedy decoding the same
tokens. Prefill + decode equals ``forward`` for the MoE configs only under a
capacity that drops nothing (a prompt's cut depends on its length; the
reference's serving test does the same). Also: the configs, the numpy
weight recipe against the reference's parameter shapes at full width, the
serve entry point (the VLM from stub embeddings), every registry arch
served, and the full-width
golden fixtures (qwen2-0.5b float32 and bfloat16, deepseek-v2-lite float32
at depth 2) against the recipe.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import prng
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import common, lm
from repro_torch.train.steps import make_decode_step, make_prefill_step

DENSE = ("qwen2-0.5b", "gemma-2b", "minicpm-2b", "starcoder2-7b")
MOE = ("deepseek-v2-lite-16b", "dbrx-132b")
#: The VLM (M-RoPE), the SSM and the hybrid family.
NEW = ("qwen2-vl-72b", "mamba2-130m", "zamba2-7b")
#: The encoder-decoder.
ENCDEC = ("whisper-large-v3",)
SERVED = DENSE + MOE + NEW + ENCDEC
OTHERS = tuple(a for a in ARCHS if a not in SERVED)
TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN = Path(__file__).parent / "fixtures" / "qwen2_0_5b_golden.npz"
GOLDEN_BF16 = GOLDEN.with_name("qwen2_0_5b_golden_bf16.npz")
GOLDEN_DEEPSEEK = GOLDEN.with_name("deepseek_v2_lite_golden.npz")


def _nodrop(cfg):
    """The MoE capacity factor at 8 (no drops at these lengths)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _port(arch, nodrop=False):
    cfg = get_config(arch, smoke=True)
    rcfg = ref_config(arch, smoke=True)
    if nodrop:
        cfg, rcfg = _nodrop(cfg), _nodrop(rcfg)
    params = ref_lm.init(jax.random.key(1), rcfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, convert.lm_params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_logits_match_reference(arch):
    cfg, params, model = _port(arch)
    rcfg = ref_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    b, t, p = 2, 20, 16
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    h, want_metrics = ref_lm.forward(params, rcfg, tokens=jnp.asarray(toks))
    full = np.asarray(ref_lm.logits_fn(params, rcfg, h))
    th, metrics = lm.forward(model, cfg, tokens=torch.from_numpy(toks))
    assert set(metrics) == set(want_metrics) == {"moe_aux", "moe_dropped"}
    assert float(metrics["moe_dropped"]) == float(want_metrics["moe_dropped"])
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(want_metrics["moe_aux"]), rtol=1e-6,
                               atol=1e-6)
    if cfg.moe is None:
        assert float(metrics["moe_aux"]) == float(metrics["moe_dropped"]) == 0
    np.testing.assert_allclose(lm.logits_fn(model, cfg, th).numpy(), full, **TOL)

    cache = ref_lm.init_cache(rcfg, b, max_len=t)
    tcache = lm.init_cache(cfg, b, max_len=t, device="cpu")
    lg, cache = ref_lm.prefill(params, rcfg, tokens=jnp.asarray(toks[:, :p]),
                               cache=cache)
    tlg, tcache = lm.prefill(model, cfg, tokens=torch.from_numpy(toks[:, :p]),
                             cache=tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    for i in range(p, t):
        lg, cache = ref_lm.decode_step(params, rcfg, jnp.asarray(toks[:, i]),
                                       cache, jnp.int32(i))
        tlg, tcache = lm.decode_step(model, cfg, torch.from_numpy(toks[:, i]),
                                     tcache, i)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        if cfg.moe is None:     # a MoE forward drops at this length
            np.testing.assert_allclose(tlg.numpy(), full[:, i], **TOL)
    # The cache the port filled in place holds the reference's (K and V,
    # MLA's latent ckv and kr, or the SSM state and conv tail), segment by
    # segment.
    for (kind, _), seg, ref_seg in zip(lm.segments(cfg), tcache, cache,
                                       strict=True):
        assert set(seg) == set(ref_seg) == (
            {"state", "conv"} if kind == "mamba"
            else {"ckv", "kr"} if cfg.mla else {"k", "v"})
        for name in seg:
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(ref_seg[name]), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_match_forward_without_drops(arch):
    """The reference's serving test for the MoE configs, on the port: under
    a capacity factor of 8 nothing drops, and prefill + teacher-forced
    decode steps give ``forward``'s logits (and the reference's)."""
    cfg, params, model = _port(arch, nodrop=True)
    rcfg = _nodrop(ref_config(arch, smoke=True))
    b, t, p = 2, 20, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    th, metrics = lm.forward(model, cfg, tokens=torch.from_numpy(toks))
    assert float(metrics["moe_dropped"]) == 0
    full = lm.logits_fn(model, cfg, th).numpy()
    h, _ = ref_lm.forward(params, rcfg, tokens=jnp.asarray(toks))
    np.testing.assert_allclose(full, np.asarray(ref_lm.logits_fn(params, rcfg, h)),
                               **TOL)
    tcache = lm.init_cache(cfg, b, max_len=t, device="cpu")
    tlg, tcache, pm = lm.prefill(model, cfg, tokens=torch.from_numpy(toks[:, :p]),
                                 cache=tcache, return_metrics=True)
    assert float(pm["moe_dropped"]) == 0
    np.testing.assert_allclose(tlg.numpy(), full[:, p - 1], rtol=3e-4, atol=3e-4)
    for i in range(p, t):
        tlg, tcache = lm.decode_step(model, cfg, torch.from_numpy(toks[:, i]),
                                     tcache, i)
        np.testing.assert_allclose(tlg.numpy(), full[:, i], rtol=3e-4, atol=3e-4)


def _serve_inputs(cfg, rcfg, b, p, gen, seed=0):
    """The prompt batch of both packages' serve steps (whisper: 24 frames
    and the tokens) and their caches."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal((b, 24, cfg.d_model)).astype(
            np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    if cfg.encdec is not None:
        caches = (ref_lm.encdec_init_cache(rcfg, b, p + gen, 24),
                  lm.encdec_init_cache(cfg, b, p + gen, 24, device="cpu"))
    else:
        caches = (ref_lm.init_cache(rcfg, b, max_len=p + gen),
                  lm.init_cache(cfg, b, max_len=p + gen, device="cpu"))
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()}, *caches)


@pytest.mark.parametrize("arch", SERVED)
def test_greedy_tokens_match_reference(arch):
    cfg, params, model = _port(arch)
    rcfg = ref_config(arch, smoke=True)
    b, p, gen = 2, 8, 8
    batch, tbatch, cache, tcache = _serve_inputs(cfg, rcfg, b, p, gen)

    def run(prefill, decode, params, cache, batch, argmax, cast):
        logits, cache = prefill(params, batch, cache)
        cur = argmax(logits)
        outs = [np.asarray(cur)]
        for i in range(gen - 1):
            cur, _, cache = decode(params, cur, cache, cast(p + i))
            outs.append(np.asarray(cur))
        return np.stack(outs, 1)

    want = run(ref_prefill_step(rcfg), ref_decode_step(rcfg), params, cache,
               batch, lambda x: jnp.argmax(x, -1).astype(jnp.int32),
               jnp.int32)
    got = run(make_prefill_step(cfg), make_decode_step(cfg), model, tcache,
              tbatch, lambda x: torch.argmax(x, -1).to(torch.int32), int)
    np.testing.assert_array_equal(got, want)


def test_serve_smoke_runs_on_cpu(capsys):
    seq = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert seq.shape == (2, 4) and seq.dtype == np.int32
    assert ((seq >= 0) & (seq < 256)).all()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=qwen2-0.5b-smoke batch=2 prompt=8 gen=4"
    assert out[1].startswith("prefill:") and out[2].startswith("decode:")
    assert out[3] == "prefill moe_dropped: 0"
    assert out[-1] == "device: cpu"


def test_serve_moe_smoke_prints_the_prefill_drops(capsys):
    seq = serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert seq.shape == (2, 3) and ((seq >= 0) & (seq < 256)).all()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=deepseek-v2-lite-smoke batch=2 prompt=16 gen=3"
    # 2 MoE layers x 2 groups x 16 tokens x top-2 at 10 slots an expert
    dropped = int(out[3].removeprefix("prefill moe_dropped: "))
    assert 0 < dropped < 2 * 2 * 16 * 2


@pytest.mark.parametrize("arch", NEW)
def test_serve_new_families_smoke_on_cpu(arch, capsys):
    """The VLM from stub embeddings, the SSM and the hybrid through the
    serve entry point (a prompt past one SSD chunk)."""
    seq = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "19", "--gen", "3"])
    assert seq.shape == (2, 3) and ((seq >= 0) & (seq < 256)).all()
    out = capsys.readouterr().out.splitlines()
    name = get_config(arch, smoke=True).name
    assert out[0] == f"arch={name} batch=2 prompt=19 gen=3"
    assert out[3] == "prefill moe_dropped: 0" and out[-1] == "device: cpu"


def test_serve_cuts_the_depth():
    seq = serve.main(["--arch", "qwen2-vl-72b", "--smoke", "--device", "cpu",
                      "--layers", "1", "--batch", "1", "--prompt-len", "4",
                      "--gen", "2"])
    assert seq.shape == (1, 2)
    with pytest.raises(ValueError, match="--layers"):
        serve.main(["--arch", "qwen2-vl-72b", "--smoke", "--device", "cpu",
                    "--layers", "3"])


@pytest.mark.parametrize("arch", ARCHS)
def test_other_families_raise(arch):
    """No family raises any more: every registry arch is served (``OTHERS``
    is empty), and its smoke config builds an LM, a cache and both serve
    steps, greedy and sampled, on the CPU."""
    assert OTHERS == () and arch in SERVED
    cfg = get_config(arch, smoke=True)
    model = lm.LM(cfg, device="cpu")
    if cfg.encdec is not None:
        cache = lm.encdec_init_cache(cfg, 1, 4, 6, device="cpu")
        assert set(cache) == {"self", "cross"}
        assert len(model.encoder.blocks) == cfg.encdec.enc_layers
        assert len(model.cross_attn) == cfg.num_layers
    else:
        assert lm.init_cache(cfg, 1, 4, device="cpu")
        assert model.encoder is None and model.cross_attn is None
    make_prefill_step(cfg)
    make_decode_step(cfg, greedy=False, temperature=0.7)


def test_sampling_raises():
    """Sampled decoding raises only without a key; with one it draws a
    token."""
    cfg, _, model = _port("qwen2-0.5b")
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    step = make_decode_step(cfg, greedy=False)
    with pytest.raises(ValueError, match="key"):
        step(model, torch.zeros(1, dtype=torch.int32), cache, 0)
    nxt, _, _ = step(model, torch.zeros(1, dtype=torch.int32), cache, 1,
                     prng.key(0))
    assert nxt.dtype == torch.int32 and 0 <= int(nxt) < cfg.vocab_size


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_configs_are_copies(arch):
    assert arch in ARCHS
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke))
                == dataclasses.asdict(ref_config(arch, smoke)))
    assert ({k: dataclasses.asdict(v) for k, v in SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()})


@pytest.mark.parametrize("arch", SERVED)
def test_recipe_has_reference_shapes_at_full_width(arch):
    """The numpy recipe's tree has ``repro.models.lm.init``'s structure and
    shapes, at full width (shapes only: nothing is drawn here)."""
    cfg = get_config(arch)
    want = jax.eval_shape(lambda k: ref_lm.init(k, ref_config(arch)),
                          jax.random.key(0))
    specs = convert._lm_leaf_specs(cfg)
    flat_want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(tuple(
        jax.tree_util.SequenceKey(k) if isinstance(k, int)
        else jax.tree_util.DictKey(k) for k in path)): tuple(shape)
        for path, shape, _ in specs}
    assert flat_got == flat_want


def test_recipe_round_trips_through_the_port():
    cfg = get_config("starcoder2-7b", smoke=True)      # layernorm, biases, untied
    tree = convert.numpy_lm_params(cfg, seed=3)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    np.testing.assert_array_equal(model.blocks[1].attn.wq.w.numpy(),
                                  tree["segments"][0]["attn"]["wq"]["w"][1])
    np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
    assert (model.blocks[0].ln2.b.numpy() == 0).all()
    w = tree["segments"][0]["ffn"]["w_up"]["w"]
    assert abs(w.std() * np.sqrt(cfg.d_model) - 1) < 0.05
    again = convert.numpy_lm_params(cfg, seed=3)
    np.testing.assert_array_equal(again["embed"], tree["embed"])
    del tree["segments"][0]["ln1"]
    with pytest.raises(ValueError, match="no leaf"):
        convert.lm_params_from_numpy(cfg, tree, device="cpu")
    tree = convert.numpy_lm_params(cfg, seed=3)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        convert.lm_params_from_numpy(cfg, tree, device="cpu")


def test_recipe_round_trips_moe_and_mla_in_bfloat16():
    """deepseek-v2-lite's recipe into a bf16 model: every leaf lands on its
    parameter; the router stays float32 and exact, the rest rounds to
    bf16; the expert weights scale by 1/sqrt(E), dense_init's fan-in."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              dtype="bfloat16")
    tree = convert.numpy_lm_params(cfg, seed=5)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    ffn, want = model.blocks[2].ffn, tree["segments"][1]["ffn"]
    assert ffn.router.w.dtype == torch.float32
    np.testing.assert_array_equal(ffn.router.w.numpy(), want["router"]["w"][1])
    assert ffn.w_down.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ffn.w_down.float().numpy(),
        torch.from_numpy(want["w_down"][1]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        model.blocks[0].attn.kv_norm.w.float().numpy(),
        np.ones(cfg.mla.kv_lora_rank, np.float32))
    e = cfg.moe.num_experts
    w = tree["segments"][1]["ffn"]["w_gate"]
    assert abs(w.std() * np.sqrt(e) - 1) < 0.05
    assert set(tree["segments"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert set(tree["segments"][1]["ffn"]["shared"]) == {"w_gate", "w_up",
                                                         "w_down"}


def test_common_ops_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    w = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, bias))
    np.testing.assert_allclose(common.rmsnorm(tx, tw, 1e-6).numpy(),
                               ref_common.rmsnorm(x, w, 1e-6), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(common.layernorm(tx, tw, tb, 1e-6).numpy(),
                               ref_common.layernorm(x, w, bias, 1e-6),
                               rtol=1e-5, atol=1e-5)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(common.act_fn(name)(tx).numpy(),
                                   ref_common.act_fn(name)(x), rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.LM(get_config("deepseek-v2-lite-16b", smoke=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke"])


def test_launch_counter_untouched_on_cpu():
    cfg, _, model = _port("qwen2-0.5b")
    fa.reset_launches()
    cache = lm.init_cache(cfg, 1, 6, device="cpu")
    _, cache = lm.prefill(model, cfg, tokens=torch.zeros(1, 5, dtype=torch.int32),
                          cache=cache)
    lm.decode_step(model, cfg, torch.zeros(1, dtype=torch.int32), cache, 5)
    assert fa.launches == {"flash_attention": 0, "flash_attention_mma": 0,
                           "flash_attention_split": 0,
                           "flash_attention_combine": 0,
                           "flash_attention_simt": 0}


def test_golden_fixture_matches_recipe():
    """The full-width golden was made from ``numpy_lm_params(cfg, seed)``:
    each leaf's path, shape and float64 sum must still come out of the
    recipe (leaf by leaf: ~10 s, at most one leaf of 545 MB at a time)."""
    g = np.load(GOLDEN)
    assert str(g["arch"]) == "qwen2-0.5b" and int(g["seed"]) == 0
    steps, b = 4, 2
    assert g["tokens"].shape == (b, int(g["prompt_len"]) + steps - 1)
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    assert int(g["topk"]) == 32 and g["lse"].shape == (steps, b)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    leaves = list(zip(g["leaf_paths"], g["leaf_shapes"], g["leaf_sums"]))
    recipe = convert.numpy_lm_leaves(cfg, int(g["seed"]))
    for (path, shape, total), (rpath, x) in zip(leaves, recipe, strict=True):
        assert path == "/".join(map(str, rpath))
        assert shape == ",".join(map(str, x.shape))
        assert x.sum(dtype=np.float64) == total, path


def test_golden_bf16_fixture_matches_recipe():
    """The full-width bf16 golden was made with the f32 golden's recipe
    (seed 0, batch 2, prompt 8, 3 decode steps) from the weights of
    ``numpy_lm_params(cfg, seed)`` rounded to bf16 as the port rounds them
    (``Tensor.copy_`` into bf16 parameters): each leaf's path, shape and the
    float64 sum of its bf16 values must still come out of the recipe."""
    g = np.load(GOLDEN_BF16)
    f32 = np.load(GOLDEN)
    assert str(g["arch"]) == "qwen2-0.5b" and str(g["dtype"]) == "bfloat16"
    for key in ("seed", "tokens", "prompt_len", "topk", "leaf_paths",
                "leaf_shapes"):
        np.testing.assert_array_equal(g[key], f32[key], err_msg=key)
    steps, b = 4, 2
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    assert g["lse"].shape == g["rms"].shape == (steps, b)
    assert np.isfinite(g["top_val"]).all() and (g["rms"] > 0).all()
    cfg = get_config("qwen2-0.5b")
    assert cfg.dtype == "bfloat16"
    recipe = convert.numpy_lm_leaves(cfg, int(g["seed"]))
    for (path, total), (rpath, x) in zip(zip(g["leaf_paths"], g["leaf_sums"]),
                                         recipe, strict=True):
        assert path == "/".join(map(str, rpath))
        bf16 = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        assert bf16.sum(dtype=np.float64) == total, path


def test_deepseek_golden_fixture_matches_recipe():
    """The deepseek-v2-lite golden (full width, depth 2, float32) was made
    from ``numpy_lm_params(cfg, seed)``: each leaf's path, shape and float64
    sum must still come out of the recipe (leaf by leaf, ~1.1 B values,
    at most one 2.2 GB expert leaf at a time); its routing arrays have the
    MoE layer's shapes."""
    g = np.load(GOLDEN_DEEPSEEK)
    assert str(g["arch"]) == "deepseek-v2-lite-16b" and int(g["seed"]) == 0
    layers, steps, b, p = int(g["layers"]), 4, 2, int(g["prompt_len"])
    assert layers == 2 and p == 64
    assert g["tokens"].shape == (b, p + steps - 1)
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=layers, dtype="float32")
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    assert g["route_idx"].shape == (1, b, p, k)
    assert g["route_prob"].shape == (1, b, p, k + 1)
    assert g["route_keep"].shape == (1, b, p * k)
    assert g["route_cut_gap"].shape == (1, b, e)
    assert int(g["moe_dropped"]) == int((~g["route_keep"]).sum()) > 0
    leaves = list(zip(g["leaf_paths"], g["leaf_shapes"], g["leaf_sums"]))
    recipe = convert.numpy_lm_leaves(cfg, int(g["seed"]))
    for (path, shape, total), (rpath, x) in zip(leaves, recipe, strict=True):
        assert path == "/".join(map(str, rpath))
        assert shape == ",".join(map(str, x.shape))
        assert x.sum(dtype=np.float64) == total, path
