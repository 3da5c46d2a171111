"""The port's LM serving path against the reference package's in bfloat16,
the dtype the card serves it in, on the CPU.

For each served smoke config (``test_torch_lm.SERVED``) in bfloat16 in both
packages, the reference's own weights (``lm.init``; the MoE router and
Mamba2's ``A_log``, ``D`` and ``dt_bias`` float32, as it makes them) go
through ``convert.lm_params_from_numpy``; ``forward``, ``prefill`` and each
teacher-forced ``decode_step`` must give the reference's bf16 logits.

The tolerance. The two packages round to bf16 at other places (eager torch
rounds each op's output, XLA once per fused chain), so neither is the
other's bf16 logits: each lies about one bf16 rounding error from the same
model in float32. The yardstick is the reference's own rounding error: E,
the relative RMS distance of its bf16 logits from its float32 logits on the
same (bf16-valued) weights; the port's distance D from the reference's bf16
logits must stay within RATIO = 1.2 x E, for the forward, the prefill and
the decode steps each. On these configs the clean port reads D / E =
0.81-1.10; RMSNorm (or LayerNorm) reduced in bf16 (no float32 upcast: two
more roundings a norm) reads 1.32-1.56 over the forward logits, and fails.
Beside it, every row's largest error must stay within ROW_TOL = 0.15 x
(|reference| + the row's RMS): the clean port reads at most 0.097, and a
fault confined to a few rows, which the RMS would average away, exceeds it.

The MoE archs' routing: the MoE inputs of both packages are read (a
``jax.debug.callback`` on the reference's ``moe.apply``, a forward pre-hook
on each port MoE module), each routed by its own package's arithmetic,
layer by layer: a top-k expert may differ only at a near-tie of the
reference's router probabilities (neighbouring ranks within ROUTE_TIE =
2e-2; the two packages' bf16 MoE inputs differ by up to ~2^-6 relative,
which moved a router probability by up to 7.1e-3 on these configs), a keep
flag of the capacity cut only beside such a near-tie or where the
reference's criticality keys at that expert's cut lie within ROUTE_TIE.
A sequence with such a near-tie has taken another expert, so its later
logits (and, the cut being over the whole sequence, all of them) are
another model's: it is counted and left out of the logit comparison, as is
a sequence whose float32 reference routes otherwise than its bf16 one.
``moe_dropped`` of each package equals the drops of its routing, and the
two drop as many on every sequence compared.

Also ``ssd_scan`` with ``compute_dtype=torch.bfloat16`` against the
reference's ``compute_dtype=jnp.bfloat16``: both round the same operands at
the same places, so they agree to float32 accumulation order (rtol = atol
= 1e-5), where keeping the decays in float32 is off by ~1e-3.
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
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import lm, moe, ssm
from test_torch_lm import SERVED
from test_torch_ssm import CHUNK, _scan_inputs

RATIO = 1.2
ROW_TOL = 0.15
ROUTE_TIE = 2e-2
#: Batch, sequence length, prompt length (then t - p decode steps).
B, T, P = 4, 20, 16

_spec = importlib.util.spec_from_file_location(
    "make_golden", Path(__file__).parent / "fixtures" / "make_mamba2_130m_golden.py")
_maker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_maker)


def _cfgs(arch, dtype):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype))


def _logits(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference(params, rcfg, toks):
    """The reference's forward logits [b, t, V], prefill logits [b, V] and
    decode logits [n, b, V], the forward's moe_dropped and the MoE inputs
    of each call (a list a call, one [b, t, d] float32 array a layer)."""
    seen = []
    apply = ref_blocks.moe_mod.apply

    def recording(p, c, x):
        jax.debug.callback(lambda v: seen.append(np.asarray(v, np.float32)), x)
        return apply(p, c, x)

    def taken():
        jax.effects_barrier()
        out = list(seen)
        seen.clear()
        return out

    ref_blocks.moe_mod.apply = recording
    try:
        h, metrics = ref_lm.forward(params, rcfg, tokens=jnp.asarray(toks))
        out = {"forward": _logits(ref_lm.logits_fn(params, rcfg, h)),
               "dropped": float(metrics["moe_dropped"]), "moe": [taken()]}
        cache = ref_lm.init_cache(rcfg, B, max_len=T)
        lg, cache = ref_lm.prefill(params, rcfg, tokens=jnp.asarray(toks[:, :P]),
                                   cache=cache)
        out["prefill"], steps = _logits(lg), []
        out["moe"].append(taken())
        for i in range(P, T):
            lg, cache = ref_lm.decode_step(params, rcfg, jnp.asarray(toks[:, i]),
                                           cache, jnp.int32(i))
            steps.append(_logits(lg))
            out["moe"].append(taken())
    finally:
        ref_blocks.moe_mod.apply = apply
    out["decode"] = np.stack(steps)
    return out


def _port(model, cfg, toks):
    """As :func:`_reference`, for the port; the MoE inputs as the port's
    modules (and their inputs) so that each is routed by the port."""
    seen = []
    hooks = [blk.ffn.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for blk in model.blocks if blk.kind == "moe"]

    def taken():
        out = list(seen)
        seen.clear()
        return out

    try:
        with torch.no_grad():
            h, metrics = lm.forward(model, cfg, tokens=torch.from_numpy(toks))
            out = {"forward": lm.logits_fn(model, cfg, h).float().numpy(),
                   "dropped": float(metrics["moe_dropped"]), "moe": [taken()]}
            cache = lm.init_cache(cfg, B, max_len=T, device="cpu")
            lg, cache = lm.prefill(model, cfg,
                                   tokens=torch.from_numpy(toks[:, :P]),
                                   cache=cache)
            out["prefill"], steps = lg.float().numpy(), []
            out["moe"].append(taken())
            for i in range(P, T):
                lg, cache = lm.decode_step(model, cfg,
                                           torch.from_numpy(toks[:, i]), cache, i)
                steps.append(lg.float().numpy())
                out["moe"].append(taken())
    finally:
        for hook in hooks:
            hook.remove()
    out["decode"] = np.stack(steps)
    return out


def _routes_ref(xs, router, rcfg):
    """The reference's routing (the golden makers' copy of its arithmetic)
    of each layer's MoE input: (top-k ids, k + 1 largest probabilities,
    keep mask, cut gap per group and expert)."""
    return [_maker.routing(x, router[j], rcfg) for j, x in enumerate(xs)]


def _routes_port(seen, cfg):
    out = []
    for mod, x in seen:
        r = moe.route(mod.router.w, cfg, x)
        out.append((r["topi"].numpy(), (r["mypos"] < r["cap"]).numpy()))
    return out


def _diverged(got, want, alive):
    """Compare the routing ``got`` [(top-k ids, keep)] with ``want`` (the
    reference's, :func:`_routes_ref`) layer by layer on the sequences still
    ``alive``: every difference must be a near-tie; a sequence with one is
    no longer alive. Returns (top-k near-ties, keep flips)."""
    ties = flips = 0
    for (topi, keep), (gi, gp, gk, gap) in zip(got, want, strict=True):
        for g in np.nonzero(alive)[0]:
            excused = set()
            for tok, r in zip(*np.nonzero(topi[g] != gi[g])):
                gaps = [gp[g, tok, r] - gp[g, tok, r + 1]]
                if r > 0:
                    gaps.append(gp[g, tok, r - 1] - gp[g, tok, r])
                assert min(gaps) < ROUTE_TIE, (
                    f"sequence {g} token {tok} rank {r}: expert "
                    f"{topi[g, tok, r]}, the reference's {gi[g, tok, r]}, "
                    f"probability gaps {gaps}")
                excused |= {int(topi[g, tok, r]), int(gi[g, tok, r])}
                ties += 1
            fe = gi[g].reshape(-1)
            for j in np.nonzero(keep[g] != gk[g])[0]:
                e = int(fe[j])
                assert e in excused or gap[g, e] < ROUTE_TIE, (
                    f"sequence {g} assignment {j} (expert {e}): kept "
                    f"{keep[g, j]}, the reference {gk[g, j]}; the cut's gap "
                    f"{gap[g, e]}")
                flips += 1
            if excused or (keep[g] != gk[g]).any():
                alive[g] = False
    return ties, flips


def _rel(got, want):
    d = np.asarray(got, np.float64) - want
    return float(np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(np.square(want, dtype=np.float64))))


def _row_err(got, want):
    rms = np.sqrt(np.mean(np.square(want, dtype=np.float64), -1, keepdims=True))
    return float((np.abs(got - want) / (np.abs(want) + rms)).max())


@pytest.mark.parametrize("arch", SERVED)
def test_bf16_logits_match_reference(arch):
    cfg, rcfg = _cfgs(arch, "bfloat16")
    params = ref_lm.init(jax.random.key(1), rcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    for name, p in model.named_parameters():
        want = (torch.float32 if name.endswith(("router.w", "A_log", "D",
                                                "dt_bias"))
                else torch.bfloat16)
        assert p.dtype == want, name
    _, rcfg32 = _cfgs(arch, "float32")
    params32 = jax.tree.map(jnp.asarray, tree)      # the bf16 values, in f32
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    want = _reference(params, rcfg, toks)
    f32 = _reference(params32, rcfg32, toks)
    got = _port(model, cfg, toks)

    # Sequences comparable: in the forward; in the prefill; in the prefill
    # and every decode step ("serve").
    alive = {"forward": np.ones(B, bool), "serve": np.ones(B, bool)}
    ties = flips = 0
    if cfg.moe is not None:
        seg = next(i for i, (kind, _) in enumerate(lm.segments(cfg))
                   if kind == "moe")
        router = np.asarray(params["segments"][seg]["ffn"]["router"]["w"])
        for call, (mine, ref, ref32) in enumerate(zip(
                got["moe"], want["moe"], f32["moe"], strict=True)):
            live = alive["forward" if call == 0 else "serve"]
            port_routes = _routes_port(mine, cfg)
            ref_routes = _routes_ref(ref, router, rcfg)
            t_, f_ = _diverged(port_routes, ref_routes, live)
            ties, flips = ties + t_, flips + f_
            _diverged([(i, k) for i, _, k, _ in
                       _routes_ref(ref32, router, rcfg)], ref_routes, live)
            if call == 1:
                alive["prefill"] = live.copy()
            if call == 0:     # the forward's drops, by sequence
                mine_drops = sum((~k).sum(-1) for _, k in port_routes)
                ref_drops = sum((~k).sum(-1) for _, _, k, _ in ref_routes)
                assert got["dropped"] == float(mine_drops.sum())
                assert want["dropped"] == float(ref_drops.sum())
                assert (mine_drops == ref_drops)[live].all()
    else:
        assert got["dropped"] == want["dropped"] == 0
    alive.setdefault("prefill", alive["serve"])
    compared = {k: int(v.sum()) for k, v in alive.items()}
    print(f"{arch}: sequences compared {compared} of {B}; routing near-ties "
          f"{ties}, keep flips {flips}")
    checks = {"forward": (got["forward"], want["forward"], f32["forward"],
                          alive["forward"]),
              "prefill": (got["prefill"], want["prefill"], f32["prefill"],
                          alive["prefill"]),
              "decode": (got["decode"], want["decode"], f32["decode"],
                         alive["serve"])}
    for call, (mine, ref, ref32, live) in checks.items():
        assert live.any(), f"{arch} {call}: every sequence took a near-tie"
        sel = (slice(None), live) if call == "decode" else live
        mine, ref, ref32 = mine[sel], ref[sel], ref32[sel]
        d, e, row = _rel(mine, ref), _rel(ref, ref32), _row_err(mine, ref)
        print(f"{arch} {call}: D {d:.5f}, E {e:.5f}, D / E {d / e:.3f}, "
              f"row error {row:.4f}")
        assert d <= RATIO * e, (call, d, e)
        assert row <= ROW_TOL, (call, row)


@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, 2 * CHUNK + 5])
def test_ssd_scan_bf16_compute_dtype_matches_reference(t):
    args = _scan_inputs(t, seed=t)
    y, state = ref_ssm.ssd_scan(*map(jnp.asarray, args), CHUNK,
                                compute_dtype=jnp.bfloat16)
    ty, tstate = ssm.ssd_scan(*map(torch.from_numpy, args), CHUNK,
                              compute_dtype=torch.bfloat16)
    assert ty.dtype == tstate.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(state), rtol=1e-5,
                               atol=1e-5)
    # The bf16 operands matter: the f32 scan is ~3e-3 away (relative RMS).
    y32, _ = ref_ssm.ssd_scan(*map(jnp.asarray, args), CHUNK)
    assert _rel(ty.numpy(), np.asarray(y32)) > 1e-3
