"""M-RoPE and the VLM (qwen2-vl-72b's smoke config, from stub patch
embeddings) of the port against the reference package's, on the CPU.

``apply_mrope`` splits a head's frequency channels into temporal, height
and width sections (16, 24, 24 of 64, repeating): only at head_dim 128 do
all three sections occur, so it is held there with three different
position streams (rtol = atol = 1e-5), as well as at the smoke width
(every channel temporal). With the three streams equal (text ids) it is
``apply_rope``. The smoke LM's ``forward``, ``prefill`` and decode steps
from embeddings give the reference's logits (f32, rtol = atol = 1e-4) and
greedy decoding the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import common, lm
from repro_torch.train.steps import make_decode_step, make_prefill_step

TOL5 = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-vl-72b"


def test_sections_are_the_reference_ones():
    assert common.MROPE_SECTIONS == ref_common.MROPE_SECTIONS
    sec = common._mrope_streams_on(64, common.MROPE_SECTIONS,
                                   torch.device("cpu")).tolist()
    assert sec == [0] * 16 + [1] * 24 + [2] * 24
    assert common._mrope_streams_on(12, common.MROPE_SECTIONS,
                                    torch.device("cpu")).tolist() == [0] * 12


@pytest.mark.parametrize("d", [24, 128, 160], ids=["smoke", "hd128", "hd160"])
def test_mrope_matches_reference_with_three_streams(d):
    rng = np.random.default_rng(d)
    b, h, t = 2, 3, 7
    x = rng.standard_normal((b, h, t, d)).astype(np.float32)
    pos = np.stack([rng.integers(0, 5000, (b, t)) for _ in range(3)],
                   1).astype(np.int32)                       # [b, 3, t]
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
    want = ref_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)
    if d == 128:    # each section's stream turns its own channels
        half = d // 2
        for s, (lo, hi) in enumerate(((0, 16), (16, 40), (40, 64))):
            one = np.broadcast_to(pos[:, s:s + 1], pos.shape).copy()
            alone = common.apply_mrope(torch.from_numpy(x),
                                       torch.from_numpy(one), 1e6).numpy()
            for c in (np.arange(lo, hi), np.arange(lo, hi) + half):
                np.testing.assert_array_equal(alone[..., c], got.numpy()[..., c])


def test_mrope_on_text_ids_is_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 4, 9, 128)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 3000, (2, 9)).astype(np.int32))
    got = common.apply_mrope(x, pos[:, None, :].expand(2, 3, 9), 1e6)
    torch.testing.assert_close(got, common.apply_rope(x, pos, 1e6), rtol=0,
                               atol=0)
    cfg = get_config(ARCH, smoke=True)
    p3 = lm.make_positions(cfg, 2, 5, offset=4)
    assert p3.shape == (2, 3, 5) and (p3 == torch.arange(4, 9)).all()
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(ref_lm.make_positions(ref_config(ARCH, True),
                                                     2, 5, offset=4)))


def _port(seed=1):
    cfg, rcfg = get_config(ARCH, smoke=True), ref_config(ARCH, smoke=True)
    params = ref_lm.init(jax.random.key(seed), rcfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, convert.lm_params_from_numpy(cfg, tree,
                                                           device="cpu")


def test_vlm_from_embeds_matches_reference():
    cfg, rcfg, params, model = _port()
    b, p, steps = 2, 21, 4
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((b, p, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    h, _ = ref_lm.forward(params, rcfg, embeds=jnp.asarray(emb))
    th, _ = lm.forward(model, cfg, embeds=torch.from_numpy(emb))
    full = np.asarray(ref_lm.logits_fn(params, rcfg, h))
    np.testing.assert_allclose(lm.logits_fn(model, cfg, th).numpy(), full,
                               **TOL)
    cache = ref_lm.init_cache(rcfg, b, max_len=p + steps)
    tcache = lm.init_cache(cfg, b, max_len=p + steps, device="cpu")
    lg, cache = ref_lm.prefill(params, rcfg, embeds=jnp.asarray(emb),
                               cache=cache)
    tlg, tcache = lm.prefill(model, cfg, embeds=torch.from_numpy(emb),
                             cache=tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tlg.numpy(), full[:, -1], **TOL)
    for i in range(steps):
        lg, cache = ref_lm.decode_step(params, rcfg, jnp.asarray(toks[:, i]),
                                       cache, jnp.int32(p + i))
        tlg, tcache = lm.decode_step(model, cfg, torch.from_numpy(toks[:, i]),
                                     tcache, p + i)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    for seg, ref_seg in zip(tcache, cache, strict=True):
        for name in ("k", "v"):
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(ref_seg[name]), **TOL)


def test_vlm_greedy_tokens_match_reference():
    cfg, rcfg, params, model = _port(seed=3)
    b, p, gen = 2, 12, 6
    emb = np.random.default_rng(4).standard_normal(
        (b, p, cfg.d_model)).astype(np.float32)

    def run(prefill, decode, params, cache, emb, argmax, cast):
        logits, cache = prefill(params, {"embeds": emb}, cache)
        cur = argmax(logits)
        outs = [np.asarray(cur)]
        for i in range(gen - 1):
            cur, _, cache = decode(params, cur, cache, cast(p + i))
            outs.append(np.asarray(cur))
        return np.stack(outs, 1)

    want = run(ref_prefill_step(rcfg), ref_decode_step(rcfg), params,
               ref_lm.init_cache(rcfg, b, max_len=p + gen), jnp.asarray(emb),
               lambda x: jnp.argmax(x, -1).astype(jnp.int32), jnp.int32)
    got = run(make_prefill_step(cfg), make_decode_step(cfg), model,
              lm.init_cache(cfg, b, max_len=p + gen, device="cpu"),
              torch.from_numpy(emb),
              lambda x: torch.argmax(x, -1).to(torch.int32), int)
    np.testing.assert_array_equal(got, want)
