"""The port's SSM and hybrid LMs against the reference package's, on the CPU.

mamba2-130m's smoke config (Mamba2 blocks only, tied head, no positions)
and zamba2-7b's (Mamba2 blocks with one shared attention + FFN block
applied at every ``attn_every``-th layer), the latter also cut to 7 layers
so that the shared block is applied twice. The reference's own weights
(``lm.init``) go through ``convert.lm_params_from_numpy``; ``forward``,
``prefill`` (a prompt past one SSD chunk and not a multiple of it) and each
teacher-forced ``decode_step`` must give the reference's logits (f32,
rtol = atol = 1e-4), every cache entry the reference's, and greedy
decoding the same tokens. Also: the shared block is one module with one
set of parameters, and each application reads and writes only its own
cache entry. And the full-width goldens that the card is held to
(mamba2-130m at full depth, zamba2-7b cut to 7 layers; float32, made by the
reference from the numpy recipe): the recipe must still make their weights.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import lm
from repro_torch.train.steps import make_decode_step, make_prefill_step

TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURES = Path(__file__).parent / "fixtures"
#: name -> (arch, layers or None for the smoke config's own).
CASES = {"mamba2": ("mamba2-130m", None), "zamba2": ("zamba2-7b", None),
         "zamba2_2apps": ("zamba2-7b", 7)}


def _cfgs(case):
    arch, layers = CASES[case]
    cfg, rcfg = get_config(arch, smoke=True), ref_config(arch, smoke=True)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        rcfg = dataclasses.replace(rcfg, num_layers=layers)
    return cfg, rcfg


def _port(case, seed=1):
    cfg, rcfg = _cfgs(case)
    params = ref_lm.init(jax.random.key(seed), rcfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, rcfg, params, convert.lm_params_from_numpy(cfg, tree,
                                                           device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_caches_match_reference(case):
    cfg, rcfg, params, model = _port(case)
    b, p, steps = 2, 2 * cfg.ssm.chunk + 5, 4
    t = p + steps
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (b, t)).astype(np.int32)
    h, _ = ref_lm.forward(params, rcfg, tokens=jnp.asarray(toks))
    full = np.asarray(ref_lm.logits_fn(params, rcfg, h))
    th, metrics = lm.forward(model, cfg, tokens=torch.from_numpy(toks))
    assert float(metrics["moe_aux"]) == float(metrics["moe_dropped"]) == 0
    np.testing.assert_allclose(lm.logits_fn(model, cfg, th).numpy(), full,
                               **TOL)

    cache = ref_lm.init_cache(rcfg, b, max_len=t)
    tcache = lm.init_cache(cfg, b, max_len=t, device="cpu")
    fa.reset_launches()
    lg, cache = ref_lm.prefill(params, rcfg, tokens=jnp.asarray(toks[:, :p]),
                               cache=cache)
    tlg, tcache = lm.prefill(model, cfg, tokens=torch.from_numpy(toks[:, :p]),
                             cache=tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    np.testing.assert_allclose(tlg.numpy(), full[:, p - 1], **TOL)
    for i in range(p, t):
        lg, cache = ref_lm.decode_step(params, rcfg, jnp.asarray(toks[:, i]),
                                       cache, jnp.int32(i))
        tlg, tcache = lm.decode_step(model, cfg, torch.from_numpy(toks[:, i]),
                                     tcache, i)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        np.testing.assert_allclose(tlg.numpy(), full[:, i], **TOL)
    assert fa.launches["flash_attention"] == 0          # the CPU: plain
    for (kind, n), seg, ref_seg in zip(lm.segments(cfg), tcache, cache,
                                       strict=True):
        want = {"state", "conv"} if kind == "mamba" else {"k", "v"}
        assert set(seg) == set(ref_seg) == want
        for name in seg:
            assert seg[name].shape[0] == n
            assert seg[name].dtype == (torch.float32 if kind == "mamba"
                                       else cfg.torch_dtype)
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(ref_seg[name]), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_reference(case):
    cfg, rcfg, params, model = _port(case, seed=2)
    b, p, gen = 2, cfg.ssm.chunk + 3, 6
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (b, p)).astype(np.int32)

    def run(prefill, decode, params, cache, toks, argmax, cast):
        logits, cache = prefill(params, {"tokens": toks}, cache)
        cur = argmax(logits)
        outs = [np.asarray(cur)]
        for i in range(gen - 1):
            cur, _, cache = decode(params, cur, cache, cast(p + i))
            outs.append(np.asarray(cur))
        return np.stack(outs, 1)

    want = run(ref_prefill_step(rcfg), ref_decode_step(rcfg), params,
               ref_lm.init_cache(rcfg, b, max_len=p + gen), jnp.asarray(toks),
               lambda x: jnp.argmax(x, -1).astype(jnp.int32), jnp.int32)
    got = run(make_prefill_step(cfg), make_decode_step(cfg), model,
              lm.init_cache(cfg, b, max_len=p + gen, device="cpu"),
              torch.from_numpy(toks),
              lambda x: torch.argmax(x, -1).to(torch.int32), int)
    np.testing.assert_array_equal(got, want)


def test_the_shared_block_is_one_module():
    """One ``shared_attn`` block: its parameters have one name each, the
    layers that apply it hold a parameterless slot, and the port's
    parameters count the reference's."""
    cfg, rcfg, _, model = _port("zamba2_2apps")
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    assert kinds == ["mamba", "mamba", "shared_attn"] * 2 + ["mamba"]
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names))
    assert any(n.startswith("shared_attn.attn.wq") for n in names)
    for i, kind in enumerate(kinds):
        own = [n for n in names if n.startswith(f"blocks.{i}.")]
        assert model.blocks[i].kind == kind
        assert bool(own) == (kind == "mamba")
    assert model.shared_attn.kind == "attn"
    assert sum(p.numel() for p in model.parameters()) == ref_lm.param_count(rcfg)
    mamba_only, _ = _cfgs("mamba2")
    assert convert.lm_params_from_numpy(
        mamba_only, convert.numpy_lm_params(mamba_only),
        device="cpu").shared_attn is None


def test_each_application_keeps_its_own_cache_entry():
    """The two applications of the shared block see different inputs, so
    their K/V entries differ; a decode step writes position ``cache_len``
    of each and nothing else of any attention entry; a shared segment's
    entry holds one application (``attn_every`` > 1)."""
    cfg, _, _, model = _port("zamba2_2apps", seed=4)
    b, p, t = 2, 19, 24
    segs = lm.segments(cfg)
    shared = [si for si, (kind, _) in enumerate(segs) if kind == "shared_attn"]
    assert [segs[si][1] for si in shared] == [1, 1]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32))
    cache = lm.init_cache(cfg, b, max_len=t, device="cpu")
    _, cache = lm.prefill(model, cfg, tokens=toks[:, :p], cache=cache)
    k0, k1 = (cache[si]["k"][0] for si in shared)
    assert (k0[:, :p] != 0).all() and (k0[:, p:] == 0).all()
    assert not torch.allclose(k0[:, :p], k1[:, :p])
    before = [{n: x.clone() for n, x in cache[si].items()} for si in shared]
    lm.decode_step(model, cfg, toks[:, p], cache, p)
    for si, old in zip(shared, before):
        for name, x in cache[si].items():
            changed = (x != old[name]).any(-1).any(-1)       # [1, b, t]
            assert changed[:, :, p].all() and not changed[:, :, :p].any()
            assert not changed[:, :, p + 1:].any()


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 24), ("zamba2-7b", 7)])
def test_golden_fixture_matches_recipe(arch, layers):
    """The golden was made from ``numpy_lm_params(cfg, seed)`` at full
    width, float32: each leaf's path, shape and float64 sum must still come
    out of the recipe (leaf by leaf; zamba2's ~903 M values, at most one
    leaf of 411 MB at a time), and the arrays have the recipe's shapes (a
    batch of 2, a 300-token prompt past one SSD chunk of 256, 3 decode
    steps)."""
    g = np.load(FIXTURES / f"{arch.replace('-', '_')}_golden.npz")
    assert str(g["arch"]) == arch and str(g["dtype"]) == "float32"
    assert int(g["seed"]) == 0 and int(g["layers"]) == layers
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    steps, b, p = 4, 2, int(g["prompt_len"])
    assert p == 300 and p > cfg.ssm.chunk and p % cfg.ssm.chunk
    assert g["tokens"].shape == (b, p + steps - 1)
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    assert g["lse"].shape == g["rms"].shape == (steps, b)
    assert np.isfinite(g["top_val"]).all() and (g["rms"] > 0).all()
    leaves = list(zip(g["leaf_paths"], g["leaf_shapes"], g["leaf_sums"]))
    recipe = convert.numpy_lm_leaves(cfg, int(g["seed"]))
    for (path, shape, total), (rpath, x) in zip(leaves, recipe, strict=True):
        assert path == "/".join(map(str, rpath))
        assert shape == ",".join(map(str, x.shape))
        assert x.sum(dtype=np.float64) == total, path
