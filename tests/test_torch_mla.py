"""The port's MLA (``repro_torch.models.mla``) against the reference's
``repro.models.mla`` on the CPU, in float32 (rtol = atol = 1e-5).

The reference's own weights (``mla.init``) are loaded into the port's
module. ``apply_seq`` (the prefill: K and V materialised from the latent,
v zero-padded to the qk width, blockwise attention at ``scale = qk **
-0.5``) must give the reference's output and latent cache (``ckv``,
``kr``); then each absorbed ``apply_decode`` step (scores against the
latent cache divided by ``sqrt(f32(qk))``) the reference's output and
cache. At DeepSeek-V2-Lite's smoke widths and at a width where the qk head
is 192 wide, as at full width.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import mla as ref_mla
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, mla

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"


def _cfgs(wide):
    cfg, rcfg = get_config(ARCH, smoke=True), ref_config(ARCH, smoke=True)
    if wide:    # full-width MLA heads (qk 128 + 64 = 192, v 128), 2 heads
        kw = dict(d_model=96, num_heads=2, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, mla=common.MLACfg(), **kw)
        rcfg = dataclasses.replace(rcfg, mla=type(rcfg.mla)(), **kw)
    return cfg, rcfg


def _port(cfg, rcfg, seed):
    params = ref_mla.init(jax.random.key(seed), rcfg)
    mod = mla.MLA(cfg, device="cpu")
    mod.load_state_dict({name: torch.from_numpy(np.array(leaf)) for name, leaf
                         in convert._flatten(jax.tree.map(np.asarray, params))},
                        strict=True)
    return params, mod


@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "qk192"])
def test_apply_seq_and_latent_match_reference(wide):
    cfg, rcfg = _cfgs(wide)
    params, mod = _port(cfg, rcfg, seed=2)
    rng = np.random.default_rng(8)
    b, t = 2, 33
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    want, wlat = ref_mla.apply_seq(params, rcfg, jnp.asarray(x),
                                   jnp.asarray(pos), return_cache=True)
    fa.reset_launches()
    got, glat = mla.apply_seq(mod, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), return_cache=True)
    assert fa.launches["flash_attention"] == 0      # the CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ckv", "kr"):
        assert glat[name].shape == wlat[name].shape
        np.testing.assert_allclose(glat[name].numpy(), np.asarray(wlat[name]),
                                   **TOL)


@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "qk192"])
def test_decode_steps_match_reference(wide):
    """Prefill through the module (cache written in place from position 0),
    then absorbed decode steps, each against the reference's step from the
    reference's cache."""
    cfg, rcfg = _cfgs(wide)
    params, mod = _port(cfg, rcfg, seed=3)
    rng = np.random.default_rng(9)
    b, p, steps = 2, 12, 5
    x = rng.standard_normal((b, p + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p)).copy()
    _, lat = ref_mla.apply_seq(params, rcfg, jnp.asarray(x[:, :p]),
                               jnp.asarray(pos), return_cache=True)
    cache = ref_mla.init_cache(rcfg, b, p + steps)
    cache = {k: cache[k].at[:, :p].set(lat[k]) for k in cache}
    tcache = mla.init_cache(cfg, b, p + steps, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: tuple(v.shape) for k, v in cache.items()}
    out, extras = mod(torch.from_numpy(x[:, :p]),
                      {"mode": "prefill", "positions": torch.from_numpy(pos),
                       "cache": tcache, "cache_len": p})
    assert extras["cache"] is tcache
    for i in range(p, p + steps):
        want, cache = ref_mla.apply_decode(params, rcfg,
                                           jnp.asarray(x[:, i:i + 1]), cache,
                                           jnp.int32(i))
        got, extras = mod(torch.from_numpy(x[:, i:i + 1]),
                          {"mode": "decode", "positions": None,
                           "cache": tcache, "cache_len": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(cache[name]), **TOL)


def test_train_mode_is_apply_seq():
    cfg, rcfg = _cfgs(False)
    _, mod = _port(cfg, rcfg, seed=4)
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(7, dtype=torch.int32).expand(2, 7)
    out, extras = mod(x, {"mode": "train", "positions": pos, "cache": None,
                          "cache_len": None})
    assert extras == {}
    torch.testing.assert_close(out, mla.apply_seq(mod, cfg, x, pos),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        mod(x, {"mode": "score", "positions": pos})


def test_rope_takes_the_single_kr_head():
    """``apply_rope`` on the ``[b, 1, t, 64]`` view of kr, as ``_latent``
    uses it, equals the reference's."""
    from repro.models import common as ref_common
    rng = np.random.default_rng(10)
    kr = rng.standard_normal((3, 1, 9, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 9)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(kr), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(ref_common.apply_rope(jnp.asarray(kr), jnp.asarray(pos), 1e4)),
        **TOL)
