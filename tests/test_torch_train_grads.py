"""The port's differentiable forward against the reference's ``jax.grad``,
family by family, on the CPU.

For one smoke config of each family (dense qwen2-0.5b, MoE with MLA
deepseek-v2-lite-16b, the VLM qwen2-vl-72b through ``embeds``, the SSM
mamba2-130m, the hybrid zamba2-7b, the encoder-decoder whisper-large-v3)
both sides take the numpy recipe's weights (``convert.numpy_lm_params``,
seed 0) and the same copy-task batch, and compute the training loss
(``make_loss_fn``: the forward, the chunked cross-entropy, the MoE term)
and its gradient with respect to every parameter. The port's gradients go
back to the reference's tree (``convert.named_to_numpy``). Tolerance, per
leaf: the largest difference at most 1e-5 of the leaf's largest magnitude
plus 1e-7 (float32; the gradients agree to ~2e-6 of that). The loss and
its metrics within 1e-6 relative.

Also: remat (``torch.utils.checkpoint``) leaves the gradients as they are;
in bfloat16 the router and the SSM's ``A_log``, ``D`` and ``dt_bias`` keep
float32 gradients; and the SSD scan's gradient where the reference's is not
finite.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import run_reference
from _torch_train import FAMILIES, flat, lm_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.train.steps import make_loss_fn

METRICS = ("xent", "accuracy", "tokens", "moe_aux", "moe_dropped")

#: The SSD scan at a decay the reference's masked exp overflows: dt = 8 a
#: step and A = -1, -2 over chunks of 16 steps give segment sums above 88
#: above the diagonal, whose exp is inf.
SSD_OVERFLOW = dict(b=1, t=32, h=2, p=4, n=8, dt=8.0, A=(-1.0, -2.0), chunk=16)


def _ssd_inputs():
    s = SSD_OVERFLOW
    rng = np.random.default_rng(0)
    return (rng.standard_normal((s["b"], s["t"], s["h"], s["p"]),
                                dtype=np.float32),
            np.full((s["b"], s["t"], s["h"]), s["dt"], np.float32),
            np.array(s["A"], np.float32),
            rng.standard_normal((s["b"], s["t"], s["n"]), dtype=np.float32),
            rng.standard_normal((s["b"], s["t"], s["n"]), dtype=np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "train_grads", """
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
import _torch_train as T
from test_torch_train_grads import METRICS, SSD_OVERFLOW, _ssd_inputs
from repro.configs import get_config
from repro.data.pipeline import SyntheticCopyTask
from repro.models import ssm
from repro.train.steps import make_loss_fn
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_params

for fam, arch in T.FAMILIES.items():
    cfg = get_config(arch, smoke=True)
    params = jax.tree.map(jnp.asarray,
                          numpy_lm_params(port_config(arch, smoke=True), 0))
    batch = {k: jnp.asarray(v) for k, v in
             T.lm_batch(cfg, copy_task=SyntheticCopyTask).items()}
    grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(cfg), has_aux=True))
    (loss, metrics), grads = grad_fn(params, batch)
    res[f"{fam}/loss"] = np.asarray(loss)
    for k in METRICS:
        if k in metrics:
            res[f"{fam}/metric/{k}"] = np.asarray(metrics[k])
    for k, v in T.flat(grads).items():
        res[f"{fam}/grad/{k}"] = v

# The SSD scan where the masked exp overflows: the reference's own gradient,
# then the same scan with the mask on the exp's argument (patched here, in
# this process only) as the oracle for the port's.
x, dt, A, B, C = (jnp.asarray(a) for a in _ssd_inputs())
f = lambda *a: ssm.ssd_scan(*a, SSD_OVERFLOW["chunk"])[0].sum()
for k, g in zip("x dt A B C".split(), jax.grad(f, argnums=range(5))(x, dt, A, B, C)):
    res[f"ssd/reference/{k}"] = np.asarray(g)

def segsum_exp_masked_argument(a):
    q = a.shape[-2]
    cs = jnp.cumsum(a, axis=-2)
    diff = cs[..., :, None, :] - cs[..., None, :, :]
    mask = jnp.arange(q)[:, None] >= jnp.arange(q)[None, :]
    return jnp.moveaxis(jnp.exp(jnp.where(mask[..., None], diff, -jnp.inf)),
                        -1, -3)

ssm._segsum_exp = segsum_exp_masked_argument
for k, g in zip("x dt A B C".split(), jax.grad(f, argnums=range(5))(x, dt, A, B, C)):
    res[f"ssd/oracle/{k}"] = np.asarray(g)
""")


def _port_grads(arch, *, remat=True, dtype=None):
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, remat=remat, dtype=dtype or cfg.dtype)
    model = convert.lm_params_from_numpy(cfg, convert.numpy_lm_params(cfg, 0),
                                         device="cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    loss, metrics = make_loss_fn(cfg)(model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, grads)}
    return cfg, loss.detach(), metrics, grads


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_match_reference(reference, family):
    cfg, loss, metrics, grads = _port_grads(FAMILIES[family])
    np.testing.assert_allclose(loss.numpy(), reference[f"{family}/loss"],
                               rtol=1e-6, atol=0)
    for k in METRICS:
        key = f"{family}/metric/{k}"
        assert (k in metrics) == (key in reference), k
        if k in metrics:
            np.testing.assert_allclose(metrics[k].detach().numpy(),
                                       reference[key], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    got = flat(convert.named_to_numpy(cfg, grads))
    prefix = f"{family}/grad/"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.isfinite(w).all() and np.isfinite(got[k]).all(), k
        bound = 1e-5 * np.abs(w).max() + 1e-7
        err = np.abs(got[k] - w).max()
        assert err <= bound, f"{family} {k}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("family", ["dense", "encdec", "hybrid"])
def test_remat_leaves_the_gradients(family):
    """Each layer under ``torch.utils.checkpoint`` (``cfg.remat``, the
    smoke configs' default) or not: the same loss and gradients (1e-6 of
    each leaf's largest magnitude)."""
    _, l1, _, g1 = _port_grads(FAMILIES[family], remat=True)
    _, l0, _, g0 = _port_grads(FAMILIES[family], remat=False)
    assert torch.equal(l1, l0)
    for n in g1:
        bound = 1e-6 * g0[n].abs().max() + 1e-9
        assert (g1[n] - g0[n]).abs().max() <= bound, n


@pytest.mark.parametrize("family", ["moe_mla", "ssm"])
def test_float32_leaves_keep_float32_gradients_in_bfloat16(family):
    """In a bfloat16 model the MoE router and Mamba2's ``A_log``, ``D`` and
    ``dt_bias`` are float32 parameters, and so are their gradients; every
    other gradient is bfloat16; all finite."""
    _, loss, _, grads = _port_grads(FAMILIES[family], dtype="bfloat16")
    assert torch.isfinite(loss)
    f32 = {n for n in grads
           if n.endswith(("router.w", "A_log", ".D", "dt_bias"))}
    assert f32
    for n, g in grads.items():
        assert g.dtype == (torch.float32 if n in f32 else torch.bfloat16), n
        assert torch.isfinite(g.float()).all(), n


def test_ssd_gradient_where_the_reference_is_not_finite(reference):
    """At ``SSD_OVERFLOW`` the reference's masked exp overflows above the
    diagonal, and its backward multiplies that inf by a zero: its gradients
    of dt and A are not finite (a fault of the reference, ROADMAP §3). The
    port masks the exp's argument instead: its gradients are finite and
    equal, within 1e-5 relative, the reference's scan with that mask (the
    oracle), which the reference's own gives where it is finite (x, B,
    C). A's gradient is the exception, at 1e-3: it sums ``dt`` times terms
    a hundred times its size, and float32 leaves ~1e-3 of it (a float64
    sequential recurrence puts both the port's and the oracle's 1.1-1.4e-3
    of its scale from the exact value)."""
    assert not np.isfinite(reference["ssd/reference/dt"]).all()
    assert not np.isfinite(reference["ssd/reference/A"]).all()
    args = [torch.from_numpy(a).requires_grad_() for a in _ssd_inputs()]
    y, _ = ssm.ssd_scan(*args, SSD_OVERFLOW["chunk"])
    grads = torch.autograd.grad(y.sum(), args)
    for k, g in zip("x dt A B C".split(), grads):
        assert torch.isfinite(g).all(), k
        want = reference[f"ssd/oracle/{k}"]
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-3 if k == "A" else 1e-5, err_msg=k)
        if k in "xBC":
            np.testing.assert_allclose(reference[f"ssd/reference/{k}"], want,
                                       rtol=0, atol=1e-5 * scale, err_msg=k)
