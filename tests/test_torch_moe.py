"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe.apply`` on the CPU, in float32.

The reference's own weights (``moe.init``) are loaded into the port's
module and the same seeded numpy input goes through both: the output within
rtol = atol = 1e-5, ``moe_dropped`` exactly equal, ``moe_aux`` within 1e-6.
Cases: no drops (capacity factor 8), drops (0.01) and the default 1.25,
under both dispatch orders, with and without shared experts; the all-zero
router, where every probability ties (the top-k and the criticality sort
must keep the lower index first, as ``jax.lax.top_k`` and the stable
``jnp.argsort`` do); the port of the reference's brute-force test, its
shared-expert and criticality-mass tests; the capacity formula.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.models import common, moe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(e=4, k=2, cf=8.0, order="criticality", shared=0, d=16, f=32):
    """The same config in both packages' schema."""
    kw = dict(name="t", family="moe", num_layers=1, d_model=d, num_heads=2,
              num_kv_heads=2, d_ff=32, vocab_size=64, dtype="float32")
    mk = dict(num_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf,
              dispatch_order=order, num_shared=shared)
    return (common.ModelConfig(**kw, moe=common.MoECfg(**mk)),
            ref_common.ModelConfig(**kw, moe=ref_common.MoECfg(**mk)))


def _port(cfg, tree):
    """The port's MoE module on the CPU holding the reference tree's
    weights."""
    mod = moe.MoE(cfg, device="cpu")
    mod.load_state_dict({name: torch.from_numpy(np.array(leaf)) for name, leaf
                         in convert._flatten(tree)}, strict=True)
    return mod


def _run_both(cfg, rcfg, x, seed=0, zero_router=False):
    params = ref_moe.init(jax.random.key(seed), rcfg)
    if zero_router:
        params["router"]["w"] = jnp.zeros_like(params["router"]["w"])
    want, wm = ref_moe.apply(params, rcfg, jnp.asarray(x))
    mod = _port(cfg, jax.tree.map(np.asarray, params))
    got, gm = moe.apply(mod, cfg, torch.from_numpy(x))
    return params, mod, (np.asarray(want), wm), (got.numpy(), gm)


def _check(want, got):
    (w, wm), (g, gm) = want, got
    assert g.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_allclose(g, w, **TOL)
    assert float(gm["moe_dropped"]) == float(wm["moe_dropped"])
    np.testing.assert_allclose(float(gm["moe_aux"]), float(wm["moe_aux"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("order", ["criticality", "arrival"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.01])
def test_matches_reference(cf, order, shared):
    cfg, rcfg = _cfgs(e=8, k=3, cf=cf, order=order, shared=shared)
    x = np.random.default_rng(4).standard_normal((3, 24, 16)).astype(np.float32)
    _, _, want, got = _run_both(cfg, rcfg, x)
    _check(want, got)
    dropped = float(got[1]["moe_dropped"])
    if cf == 8.0:
        assert dropped == 0
    if cf == 0.01:                  # one slot an expert: 3 x 24 x 3 - 3 x 8
        assert dropped == 3 * 24 * 3 - 3 * 8


@pytest.mark.parametrize("order", ["criticality", "arrival"])
@pytest.mark.parametrize("cf", [8.0, 0.3])
def test_tied_router_matches_reference(cf, order):
    """All-zero router: every probability is 1/E, so the top-k is experts
    0..k-1 for every token (lower index first on ties) and the criticality
    key ties within each expert (the stable sort keeps token order)."""
    cfg, rcfg = _cfgs(cf=cf, order=order)
    x = np.random.default_rng(5).standard_normal((2, 64, 16)).astype(np.float32)
    _, mod, want, got = _run_both(cfg, rcfg, x, zero_router=True)
    _check(want, got)
    # uniform probs: E * sum_e (1/E * f_e) = k
    assert float(got[1]["moe_aux"]) == cfg.moe.top_k
    r = moe.route(mod.router.w, cfg, torch.from_numpy(x))
    assert (r["topi"] == torch.arange(cfg.moe.top_k)).all()
    if order == "criticality":      # ties keep token order: the FCFS cut
        arrival, _ = _cfgs(cf=cf, order="arrival")
        fcfs = moe.route(mod.router.w, arrival, torch.from_numpy(x))
        assert torch.equal(r["mypos"], fcfs["mypos"])


def test_top_k_keeps_lower_index_first_on_ties():
    rng = np.random.default_rng(6)
    p = rng.integers(0, 4, (50, 16)).astype(np.float32) / 4   # many ties
    vals, idx = moe.top_k(torch.from_numpy(p), 5)
    rv, ri = jax.lax.top_k(jnp.asarray(p), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_capacity_formula():
    for e, k, cf in ((4, 2, 1.25), (64, 6, 1.25), (16, 4, 0.01), (8, 3, 8.0)):
        cfg, _ = _cfgs(e=e, k=k, cf=cf)
        for t in (1, 2, 7, 64, 2048):
            want = min(max(1, math.ceil(k * t * cf / e)), t * k)
            assert moe.capacity(cfg, t) == want
    cfg, _ = _cfgs(e=64, k=6, cf=1.25)
    assert moe.capacity(cfg, 64) == 8 and moe.capacity(cfg, 1) == 1
    assert moe.capacity(cfg, 2048) == 240


def test_matches_bruteforce_no_drops():
    """The reference's brute-force test on the port: every expert evaluated
    densely, combined with the renormalised router weights."""
    cfg, rcfg = _cfgs()
    params = ref_moe.init(jax.random.key(0), rcfg)
    mod = _port(cfg, jax.tree.map(np.asarray, params))
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.key(1), (2, 10, 16), jnp.float32)))
    out, m = moe.apply(mod, cfg, x)
    assert float(m["moe_dropped"]) == 0.0
    probs = torch.softmax(x @ mod.router.w, -1)
    topw, topi = moe.top_k(probs, cfg.moe.top_k)
    topw = topw / topw.sum(-1, keepdim=True)
    dense = torch.stack([
        (torch.nn.functional.silu(x @ mod.w_gate[e]) * (x @ mod.w_up[e]))
        @ mod.w_down[e] for e in range(cfg.moe.num_experts)], dim=2)
    mask = torch.nn.functional.one_hot(topi, cfg.moe.num_experts) * topw[..., None]
    want = torch.einsum("btke,bted->btd", mask, dense)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_shared_experts_added():
    cfg, rcfg = _cfgs(shared=1)
    params = jax.tree.map(np.asarray, ref_moe.init(jax.random.key(0), rcfg))
    mod = _port(cfg, params)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 6, 16)).astype(np.float32))
    out, _ = moe.apply(mod, cfg, x)
    routed_cfg, _ = _cfgs()
    routed_tree = {k: v for k, v in params.items() if k != "shared"}
    routed, _ = moe.apply(_port(routed_cfg, routed_tree), routed_cfg, x)
    torch.testing.assert_close(out - mod.shared(x), routed, rtol=2e-4, atol=2e-4)


def test_criticality_dispatch_keeps_more_router_mass():
    """Under capacity pressure the criticality-ordered cut keeps at least
    the routed probability mass of the arrival-order cut, and without
    pressure the two give the same output."""
    cfg_c, rcfg = _cfgs(cf=0.15)
    cfg_a, _ = _cfgs(cf=0.15, order="arrival")
    mod = _port(cfg_c, jax.tree.map(np.asarray, ref_moe.init(jax.random.key(0),
                                                             rcfg)))
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.key(1), (2, 12, 16), jnp.float32)))

    def kept_mass(cfg):
        r = moe.route(mod.router.w, cfg, x)
        return float((r["topw"].reshape(2, -1) * (r["mypos"] < r["cap"])).sum())

    assert kept_mass(cfg_c) > kept_mass(cfg_a)
    o1, _ = moe.apply(mod, _cfgs(cf=8.0)[0], x)
    o2, _ = moe.apply(mod, _cfgs(cf=8.0, order="arrival")[0], x)
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)


def test_bfloat16_keeps_the_router_float32():
    cfg, _ = _cfgs(shared=1)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    mod = moe.MoE(cfg, generator=torch.Generator().manual_seed(0))
    assert mod.router.w.dtype == torch.float32
    assert mod.w_gate.dtype == mod.shared.w_up.w.dtype == torch.bfloat16
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(1))
    out, m = moe.apply(mod, cfg, x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 9, 16)
    assert m["moe_aux"].dtype == m["moe_dropped"].dtype == torch.float32
    assert torch.isfinite(out.float()).all()


def test_unknown_dispatch_order_raises():
    cfg, _ = _cfgs(order="random")
    mod = moe.MoE(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dispatch_order"):
        moe.apply(mod, cfg, torch.zeros(1, 4, 16))
