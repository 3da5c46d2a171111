"""The port's encoder-decoder (whisper) against the reference package's, on
the CPU.

Module by module, on numpy-seeded inputs, f32: ``sinusoid_positions`` and
``_sinusoid_at`` (1e-6); the encoder's non-causal self-attention, cross-
attention in prefill (its cache written in place) and in decode, one
encoder block, ``encode`` and ``forward_encdec`` (1e-5); then the whisper
smoke LM through ``prefill_encdec`` and teacher-forced
``decode_step_encdec`` (1e-4; caches too), with greedy tokens equal, at a
frame count that is a multiple of the plain version's 32-key chunk and one
that is not. The reference's own weights (``lm.init``) go through
``convert.lm_params_from_numpy``. Also: the numpy recipe at whisper's
shapes, the serve entry point, and the full-width golden that the card is
held to (``tests/fixtures/whisper_large_v3_golden.npz``): the recipe must
still make its weights, and the port at full width and depth 2 must give
its ``small_*`` logits; and the kernel launches ``chip_smoke.py`` expects of
the whisper serve run on the card follow from ``plan``.
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
from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention, common, lm
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCH = "whisper-large-v3"
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
#: Encoder lengths: 40 is not a multiple of the smoke config's 32-key
#: chunk, 64 is.
FRAMES = (40, 64)
GOLDEN = Path(__file__).parent / "fixtures" / "whisper_large_v3_golden.npz"


def _port(seed=1):
    cfg, rcfg = get_config(ARCH, smoke=True), ref_config(ARCH, smoke=True)
    params = ref_lm.init(jax.random.key(seed), rcfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, convert.lm_params_from_numpy(cfg, tree,
                                                           device="cpu")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,d,offset", [(1, 64, 0), (40, 64, 0), (150, 1280, 0),
                                        (9, 1280, 1491), (1500, 1280, 0)])
def test_sinusoid_positions_match_reference(t, d, offset):
    got = common.sinusoid_positions(t, d, offset, device="cpu")
    want = np.asarray(ref_common.sinusoid_positions(t, d, offset))
    assert got.dtype == torch.float32 and got.shape == (t, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_at_matches_reference(d):
    """A decode step's sinusoids, from ``cache_len`` in f32 sin and cos
    (not a row of the numpy table, whose angles are float64)."""
    for pos in (0, 1, 74, 75, 777, 1499, 65535):
        got = lm._sinusoid_at(pos, d, device="cpu")
        want = np.asarray(ref_lm._sinusoid_at(jnp.int32(pos), d))
        assert got.dtype == torch.float32 and got.shape == (d,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_non_causal_self_attention_matches_reference(t_enc):
    cfg, rcfg, params, model = _port()
    x = _normal(np.random.default_rng(t_enc), 2, t_enc, cfg.d_model)
    aux = {"mode": "train", "positions": None, "cache": None,
           "cache_len": None}
    p = params["encoder"]["blocks"]
    want, _ = ref_blocks.attn_apply(jax.tree.map(lambda a: a[1], p)["attn"],
                                    rcfg, jnp.asarray(x), aux, causal=False)
    got, extras = model.encoder.blocks[1].attn(torch.from_numpy(x), aux,
                                               causal=False)
    assert extras == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    causal, _ = model.encoder.blocks[1].attn(torch.from_numpy(x), aux)
    assert not torch.allclose(causal, got, atol=1e-3)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_encoder_block_matches_reference(t_enc):
    """One encoder block: ln1, non-causal attention, ln2, the GELU MLP with
    biases, each with its residual (the reference's ``encode`` body)."""
    cfg, rcfg, params, model = _port(seed=2)
    x = _normal(np.random.default_rng(t_enc + 1), 2, t_enc, cfg.d_model)
    p = jax.tree.map(lambda a: a[0], params["encoder"]["blocks"])
    aux = {"mode": "train", "positions": None, "cache": None,
           "cache_len": None}
    h = jnp.asarray(x)
    y, _ = ref_blocks.attn_apply(p["attn"], rcfg,
                                 ref_blocks.apply_norm(p["ln1"], rcfg, h),
                                 aux, causal=False)
    h = h + y
    want = h + ref_blocks.mlp_apply(p["ffn"], rcfg,
                                    ref_blocks.apply_norm(p["ln2"], rcfg, h))
    blk = model.encoder.blocks[0]
    th = torch.from_numpy(x)
    y, _ = blk.attn(blk.ln1(th), aux, causal=False)
    th = th + y
    got = th + blk.ffn(blk.ln2(th))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_cross_attention_matches_reference(t_enc):
    """Prefill: k and v projected from the encoder states (once), written
    into the layer's cross cache in place, and attended non-causally; the
    output equals ``attn_apply(kv_override=...)``. Decode: q projected by
    hand over the whole cache, then ``wo`` with its bias, as the
    reference's decoder does."""
    cfg, rcfg, params, model = _port(seed=3)
    rng = np.random.default_rng(t_enc + 2)
    b, t = 2, 7
    x, enc = _normal(rng, b, t, cfg.d_model), _normal(rng, b, t_enc, cfg.d_model)
    p = jax.tree.map(lambda a: a[1], params["cross_attn"])["attn"]
    xa = model.cross_attn[1].attn
    want, _ = ref_blocks.attn_apply(p, rcfg, jnp.asarray(x),
                                    {"mode": "prefill"},
                                    kv_override=jnp.asarray(enc))
    cache = {n: torch.zeros(b, t_enc, cfg.num_kv_heads, cfg.hd)
             for n in ("k", "v")}
    got, extras = xa(torch.from_numpy(x), {"mode": "prefill", "cache": cache},
                     kv_override=torch.from_numpy(enc))
    assert extras["cache"] is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    for name, w in (("k", "wk"), ("v", "wv")):
        proj = ref_blocks._proj(p[w], jnp.asarray(enc)).reshape(
            b, t_enc, cfg.num_kv_heads, cfg.hd)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(proj),
                                   **MODULE_TOL)
    # train mode, no cache: the same output
    same, extras = xa(torch.from_numpy(x), {"mode": "train"},
                      kv_override=torch.from_numpy(enc))
    assert extras == {}
    torch.testing.assert_close(same, got, rtol=0, atol=0)

    x1 = x[:, :1]
    q = ref_blocks._proj(p["wq"], jnp.asarray(x1)).reshape(
        b, 1, cfg.num_heads, cfg.hd)
    k, v = (jnp.asarray(cache[n].numpy()) for n in ("k", "v"))
    y = ref_attention.blockwise_attention(q, k, v, causal=False,
                                          q_chunk=rcfg.attn_chunk,
                                          kv_chunk=rcfg.attn_chunk)
    want = y.reshape(b, 1, -1) @ p["wo"]["w"] + p["wo"]["b"]
    got = xa.attend_cached(torch.from_numpy(x1), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_encode_and_forward_encdec_match_reference(t_enc):
    cfg, rcfg, params, model = _port(seed=4)
    rng = np.random.default_rng(t_enc + 3)
    frames = _normal(rng, 2, t_enc, cfg.d_model)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(ref_lm.encode(params, rcfg, jnp.asarray(frames)))
    got = lm.encode(model, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)
    h, metrics = ref_lm.forward_encdec(params, rcfg, jnp.asarray(frames),
                                       jnp.asarray(toks))
    th, tmetrics = lm.forward_encdec(model, cfg, torch.from_numpy(frames),
                                     torch.from_numpy(toks))
    assert metrics == tmetrics == {}
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **MODULE_TOL)
    np.testing.assert_allclose(lm.logits_fn(model, cfg, th).numpy(),
                               np.asarray(ref_lm.logits_fn(params, rcfg, h)),
                               **MODULE_TOL)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_prefill_and_decode_match_reference(t_enc):
    """The whisper smoke LM: a prefill of 9 tokens over ``t_enc`` frames
    and 5 teacher-forced decode steps give the reference's logits, and
    ``forward_encdec``'s at each position; both caches hold the
    reference's."""
    cfg, rcfg, params, model = _port()
    rng = np.random.default_rng(t_enc)
    b, p, n = 2, 9, 5
    frames = _normal(rng, b, t_enc, cfg.d_model)
    toks = rng.integers(0, cfg.vocab_size, (b, p + n)).astype(np.int32)
    h, _ = ref_lm.forward_encdec(params, rcfg, jnp.asarray(frames),
                                 jnp.asarray(toks))
    full = np.asarray(ref_lm.logits_fn(params, rcfg, h))
    cache = ref_lm.encdec_init_cache(rcfg, b, p + n, t_enc)
    tcache = lm.encdec_init_cache(cfg, b, p + n, t_enc, device="cpu")
    lg, cache = ref_lm.prefill_encdec(params, rcfg, jnp.asarray(frames),
                                      jnp.asarray(toks[:, :p]), cache)
    tlg, tcache = lm.prefill_encdec(model, cfg, torch.from_numpy(frames),
                                    torch.from_numpy(toks[:, :p]), tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tlg.numpy(), full[:, p - 1], **TOL)
    for i in range(p, p + n):
        lg, cache = ref_lm.decode_step_encdec(
            params, rcfg, jnp.asarray(toks[:, i]), cache, jnp.int32(i))
        tlg, tcache = lm.decode_step_encdec(model, cfg,
                                            torch.from_numpy(toks[:, i]),
                                            tcache, i)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        np.testing.assert_allclose(tlg.numpy(), full[:, i], **TOL)
    for part in ("self", "cross"):
        assert set(tcache[part]) == set(cache[part]) == {"k", "v"}
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[part][name].numpy(),
                                       np.asarray(cache[part][name]), **TOL)


@pytest.mark.parametrize("t_enc", FRAMES)
def test_greedy_tokens_match_reference(t_enc):
    cfg, rcfg, params, model = _port(seed=5)
    rng = np.random.default_rng(t_enc + 4)
    b, p, gen = 2, 8, 8
    frames = _normal(rng, b, t_enc, cfg.d_model)
    toks = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)

    def run(prefill, decode, params, cache, batch, argmax, cast):
        logits, cache = prefill(params, batch, cache)
        cur = argmax(logits)
        outs = [np.asarray(cur)]
        for i in range(gen - 1):
            cur, _, cache = decode(params, cur, cache, cast(p + i))
            outs.append(np.asarray(cur))
        return np.stack(outs, 1)

    want = run(ref_prefill_step(rcfg), ref_decode_step(rcfg), params,
               ref_lm.encdec_init_cache(rcfg, b, p + gen, t_enc),
               {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
               lambda x: jnp.argmax(x, -1).astype(jnp.int32), jnp.int32)
    got = run(make_prefill_step(cfg), make_decode_step(cfg), model,
              lm.encdec_init_cache(cfg, b, p + gen, t_enc, device="cpu"),
              {"frames": torch.from_numpy(frames),
               "tokens": torch.from_numpy(toks)},
              lambda x: torch.argmax(x, -1).to(torch.int32), int)
    np.testing.assert_array_equal(got, want)


def test_caches_are_written_in_place():
    """The prefill writes the cross cache whole and the self cache's first
    p positions; a decode step writes position ``cache_len`` of each self
    entry and leaves the cross cache as it was."""
    cfg, _, _, model = _port()
    rng = np.random.default_rng(6)
    b, t_enc, p = 2, 40, 5
    frames = torch.from_numpy(_normal(rng, b, t_enc, cfg.d_model))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p + 1))
                            .astype(np.int32))
    cache = lm.encdec_init_cache(cfg, b, p + 3, t_enc, device="cpu")
    k_self, k_cross = cache["self"]["k"], cache["cross"]["k"]
    assert k_self.shape == (cfg.num_layers, b, p + 3, cfg.num_kv_heads, cfg.hd)
    assert k_cross.shape == (cfg.num_layers, b, t_enc, cfg.num_kv_heads,
                             cfg.hd)
    _, out = lm.prefill_encdec(model, cfg, frames, toks[:, :p], cache)
    assert out["self"]["k"] is k_self and out["cross"]["k"] is k_cross
    assert (k_cross != 0).all() and (k_self[:, :, :p] != 0).all()
    assert (k_self[:, :, p:] == 0).all()
    cross = {n: x.clone() for n, x in cache["cross"].items()}
    lm.decode_step_encdec(model, cfg, toks[:, p], cache, p)
    for n in ("k", "v"):
        assert torch.equal(cache["cross"][n], cross[n])
    assert (k_self[:, :, p] != 0).all() and (k_self[:, :, p + 1:] == 0).all()


def test_encoder_uses_the_forward_form_of_attention(monkeypatch):
    """The encoder's attention is the forward form (the kernel, its plain
    version on the CPU) under ``torch.no_grad()``, as the serve steps run
    it, and the differentiable training form with gradients enabled, as
    ``forward_encdec`` trains it; both compute the same function, and only
    the training form carries a gradient. ``train_attention`` is counted to
    show which form ran: never under ``no_grad``, once a layer with
    gradients."""
    calls = []
    train_form = attention.train_attention
    monkeypatch.setattr(attention, "train_attention",
                        lambda *a, **k: calls.append(1) or train_form(*a, **k))
    cfg, _, _, model = _port()
    frames = torch.from_numpy(_normal(np.random.default_rng(7), 2, 40,
                                      cfg.d_model))
    with torch.no_grad():
        served = lm.encode(model, cfg, frames)
    assert not served.requires_grad and calls == []
    model.requires_grad_(True)
    trained = lm.encode(model, cfg, frames)
    assert trained.requires_grad
    assert len(calls) == cfg.encdec.enc_layers
    torch.testing.assert_close(trained.detach(), served, **MODULE_TOL)
    trained.square().mean().backward()
    w = model.encoder.blocks[0].attn.wq.w
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert w.grad.abs().max() > 0


def test_recipe_round_trips_whisper():
    """The numpy recipe at the smoke config: the encoder's blocks and the
    cross-attention land layer by layer, the stacked leaves scaled by the
    fan-in of a layer's matrix, every bias zero, every norm one."""
    cfg = get_config(ARCH, smoke=True)
    tree = convert.numpy_lm_params(cfg, seed=3)
    assert set(tree) == {"embed", "segments", "final_norm", "encoder",
                         "cross_attn"}
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    enc, xa = tree["encoder"]["blocks"], tree["cross_attn"]
    assert enc["attn"]["wq"]["w"].shape == (2, cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(model.encoder.blocks[1].ffn.w_up.w.numpy(),
                                  enc["ffn"]["w_up"]["w"][1])
    np.testing.assert_array_equal(model.cross_attn[1].attn.wo.w.numpy(),
                                  xa["attn"]["wo"]["w"][1])
    assert (model.cross_attn[0].ln.w.numpy() == 1).all()
    assert (model.cross_attn[0].attn.wq.b.numpy() == 0).all()
    assert (model.encoder.final_norm.b.numpy() == 0).all()
    w = enc["ffn"]["w_down"]["w"]
    assert abs(w.std() * np.sqrt(cfg.d_ff) - 1) < 0.05
    del tree["cross_attn"]["ln"]
    with pytest.raises(ValueError, match="no leaf"):
        convert.lm_params_from_numpy(cfg, tree, device="cpu")
    tree = convert.numpy_lm_params(cfg, seed=3)
    tree["encoder"]["blocks"]["ln1"]["w"] = tree["encoder"]["blocks"]["ln1"][
        "w"][:1]
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params_from_numpy(cfg, tree, device="cpu")


def test_serve_whisper_smoke_on_cpu(capsys):
    """The serve entry point: frames [b, 2 x prompt, d] drawn before the
    tokens from ``default_rng(0)``, the encdec cache, the same lines as
    every other family."""
    seq = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "19", "--gen", "3"])
    assert seq.shape == (2, 3) and ((seq >= 0) & (seq < 256)).all()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=whisper-large-v3-smoke batch=2 prompt=19 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode:")
    assert out[3] == "prefill moe_dropped: 0" and out[-1] == "device: cpu"
    # The same run by hand: the weights serve.main draws, its inputs.
    cfg = get_config(ARCH, smoke=True)
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((2, 38, cfg.d_model))).float()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 19))
                            .astype(np.int32))
    cache = lm.encdec_init_cache(cfg, 2, 22, 38, device="cpu")
    logits, cache = lm.prefill_encdec(model, cfg, frames, toks, cache)
    cur = torch.argmax(logits, -1).to(torch.int32)
    assert cur.tolist() == seq[:, 0].tolist()


def _golden_cfg(layers):
    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                               encdec=dataclasses.replace(cfg.encdec,
                                                          enc_layers=layers))


def _golden_inputs(g, cfg):
    """The golden's frames and tokens, drawn again from its seed as its
    script draws them (frames first)."""
    rng = np.random.default_rng(int(g["seed"]))
    b = g["tokens"].shape[0]
    frames = rng.standard_normal((b, int(g["frames_len"]), cfg.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, g["tokens"].shape).astype(np.int32)
    assert frames.sum(dtype=np.float64) == float(g["frames_sum"])
    np.testing.assert_array_equal(tokens, g["tokens"])
    return frames, tokens


def test_golden_fixture_matches_recipe():
    """The full-width golden (32 + 32 layers, float32) was made from
    ``numpy_lm_params(cfg, seed)``: its leaves' paths and shapes are the
    recipe's (1,535,841,280 values, ``lm.param_count`` of the reference),
    its unstacked leaves' float64 sums still come out of the recipe (the
    stacked ones' values are held by the depth-2 logits below, whose
    leaves are their first two layers, and on the card), and its inputs
    come out of its seed."""
    g = np.load(GOLDEN)
    assert str(g["arch"]) == ARCH and str(g["dtype"]) == "float32"
    assert int(g["seed"]) == 0 and int(g["layers"]) == 32
    steps, b, p = 4, 2, int(g["prompt_len"])
    assert (p, int(g["frames_len"])) == (75, 150)
    assert g["tokens"].shape == (b, p + steps - 1)
    for pre in ("", "small_"):
        assert g[pre + "top_idx"].shape == g[pre + "top_val"].shape == (
            steps, b, 40)
        assert g[pre + "lse"].shape == g[pre + "rms"].shape == (steps, b)
        assert np.isfinite(g[pre + "top_val"]).all()
    cfg = _golden_cfg(int(g["layers"]))
    _golden_inputs(g, cfg)
    specs = convert._lm_leaf_specs(cfg)
    assert [str(p) for p in g["leaf_paths"]] == [
        "/".join(map(str, path)) for path, _, _ in specs]
    assert [str(s) for s in g["leaf_shapes"]] == [
        ",".join(map(str, shape)) for _, shape, _ in specs]
    assert sum(int(np.prod(shape)) for _, shape, _ in specs) == 1_535_841_280
    for i, ((path, shape, init), total) in enumerate(zip(specs,
                                                         g["leaf_sums"])):
        if not convert._stacked(path):
            x = convert._draw_leaf(i, path, shape, init, int(g["seed"]))
            assert x.sum(dtype=np.float64) == total, path


def test_port_matches_golden_at_depth_2():
    """The port on the CPU at full width, 2 encoder and 2 decoder layers,
    f32, the recipe's weights: the prefill over the golden's 150 frames and
    3 teacher-forced decode steps give its ``small_*`` logits (at the
    golden's top-32 indices) and logsumexps within 1e-4."""
    g = np.load(GOLDEN)
    cfg = _golden_cfg(int(g["small_layers"]))
    frames, tokens = _golden_inputs(g, cfg)
    model = convert.lm_params_from_numpy(
        cfg, convert.numpy_lm_params(cfg, int(g["seed"])), device="cpu")
    p, b = int(g["prompt_len"]), tokens.shape[0]
    cache = lm.encdec_init_cache(cfg, b, tokens.shape[1], frames.shape[1],
                                 device="cpu")
    logits, cache = lm.prefill_encdec(model, cfg, torch.from_numpy(frames),
                                      torch.from_numpy(tokens[:, :p]), cache)
    steps = [logits]
    for i in range(p, tokens.shape[1]):
        logits, cache = lm.decode_step_encdec(
            model, cfg, torch.from_numpy(tokens[:, i]), cache, i)
        steps.append(logits)
    lg = torch.stack(steps).numpy()
    k = int(g["topk"])
    at = np.take_along_axis(lg, g["small_top_idx"][..., :k], -1)
    np.testing.assert_allclose(at, g["small_top_val"][..., :k], **TOL)
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse, g["small_lse"], **TOL)


def test_chip_smoke_whisper_launches_follow_the_plan():
    """The counts the card's whisper serve run is held to (96 ``mma``, 1,984
    ``split`` and 1,984 ``combine``) are what ``plan`` gives at batch 8,
    1,500 frames, a 750-token prompt and 32 new tokens, and each of the five
    timed whisper shapes takes the body the table names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_config(ARCH)
    b, p, gen = (int(x) for x in cs.WHISPER_SERVE_ARGS[3::2])
    assert (b, p, gen) == (8, 750, 32)
    assert cs.whisper_serve_want(fa, cfg, b, p, gen) == cs.WHISPER_SERVE_BODIES
    assert cs.WHISPER_SERVE_BODIES["flash_attention_mma"] == 96
    assert cs.WHISPER_SERVE_BODIES["flash_attention_split"] == 1984
    for case, (b, hq, hkv, tq, tkv, d, causal, kv_len, _, bodies) in \
            cs.WHISPER_CASES.items():
        assert (hq, hkv, d) == (cfg.num_heads, cfg.num_kv_heads, cfg.hd)
        for dtype, body in zip((torch.float32, torch.bfloat16), bodies):
            assert fa.plan(b, tq, tkv, hq, hkv, d, dtype, kv_len).body == body
