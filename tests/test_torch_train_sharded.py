"""The port's sharded train step (``repro_torch.train.sharded``) on the
reference's 2x4 mesh, on the CPU.

The reference executes ``tests/test_sharding.py``'s ``SPMD_SCRIPT`` step
(``jax.jit(make_train_step(...), in_shardings=state and batch shardings,
out_shardings=...)`` on a ("data", "model") mesh of (2, 4), ``fsdp=True``)
on 8 fake host devices, from the numpy recipe's weights and a fresh AdamW
state placed by ``state_specs``. The port runs the same state and global
batch on 8 gloo ranks as a (2, 4) mesh (``convert.train_state_from_numpy(...,
mesh=)``, each rank's rows by ``batch_rows``) and gathers the new state.
Cases:

  * ``dense``: qwen2-0.5b's smoke config on the copy task's batch of 8 x
    31 tokens, with its mask and, on top, a ragged mask (so the data ranks'
    denominators differ: the loss's sums are reduced before they divide);
  * ``moe``: deepseek-v2-lite-16b's smoke config (MoE routing and the
    load-balance term over the global batch, MLA's leaves) on the same
    kind of batch;
  * ``accum``: qwen2-0.5b with ``grad_accum=2`` (microbatch i is the global
    rows [4i, 4i + 4), as the reference cuts it);
  * each against the port's own one-device step on the global batch.

Tolerances (float32): the metrics 1e-5 relative (the ranks' sums add in
another order, ~1e-7 apart); ``count`` and ``step`` equal; the moments
within 1e-5 of each leaf's scale; the parameters and master weights within
1e-3 x lr at 99.9% of each leaf's elements and 2 x lr everywhere. Adam
turns the ~1e-7 by which the two sums of a gradient round apart into a
visible part of lr where the gradient is near eps (1e-8): the update is lr
x g / (|g| + eps), at most lr either way (up to 8.6e-5 = 0.017 lr seen on
the ``accum`` case, 99.9% within 1.5e-6 = 3e-4 lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import run_ranks, run_reference
from _torch_train import flat
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticCopyTask
from repro_torch.optim import AdamW, wsd_schedule
from repro_torch.train.steps import make_train_step

#: name -> (arch, grad_accum).
CASES = {"dense": ("qwen2-0.5b", 1), "moe": ("deepseek-v2-lite-16b", 1),
         "accum": ("qwen2-0.5b", 2)}
LR = (1e-2, 2, 10, 3)                     # the WSD schedule's arguments
MESH = (2, 4)


def config(arch, module=None):
    """The smoke config with ``fsdp=True`` (the reference's or the
    port's)."""
    if module is None:
        from repro_torch.configs import get_config as module
    return dataclasses.replace(module(arch, smoke=True), fsdp=True)


def numpy_state(cfg):
    """The reference's fresh train state from the numpy recipe's weights."""
    tree = convert.numpy_lm_params(cfg, 0)
    zeros = convert._map_tree(np.zeros_like, tree)
    return {"params": tree, "opt": {"m": zeros, "v": zeros, "master": tree,
                                    "count": np.int32(0)},
            "step": np.int32(0)}


def global_batch(cfg):
    """The copy task's batch of 8 rows, its mask times a ragged one."""
    b = SyntheticCopyTask(cfg.vocab_size, batch=8, seq=32, seed=0).batch_at(0)
    ragged = np.random.default_rng(3).random(b["mask"].shape) < 0.7
    b["mask"] = b["mask"] * ragged.astype(np.float32)
    return b


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "train_sharded", f"""
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
import _torch_train as T
import test_torch_train_sharded as S
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.mesh import _make_mesh
from repro.optim import AdamW, wsd_schedule
from repro.train import steps as tsteps

assert len(jax.devices()) == 8
mesh = _make_mesh(S.MESH, ("data", "model"))    # the reference's Auto axes
for case, (arch, ga) in S.CASES.items():
    cfg = S.config(arch, get_config)
    opt = AdamW(lr=wsd_schedule(*S.LR), weight_decay=0.01)
    state = jax.tree.map(jnp.asarray, S.numpy_state(S.config(arch)))
    sspecs = shd.state_specs(cfg, state, mesh)
    batch = {{k: jnp.asarray(v) for k, v in S.global_batch(cfg).items()}}
    bspecs = shd.batch_specs(cfg, batch, mesh)
    state = jax.device_put(state, shd.to_shardings(mesh, sspecs))
    batch = jax.device_put(batch, shd.to_shardings(mesh, bspecs))
    fn = tsteps.make_train_step(cfg, opt, grad_accum=ga)
    jfn = jax.jit(fn, in_shardings=(shd.to_shardings(mesh, sspecs),
                                    shd.to_shardings(mesh, bspecs)),
                  out_shardings=(shd.to_shardings(mesh, sspecs), None))
    with mesh:
        state, m = jfn(state, batch)
    res.update(T.flat(m, f"{{case}}/metrics/"))
    res.update(T.flat(state, f"{{case}}/state/"))
""", env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})


_PORT = f"""
import sys
sys.path.insert(0, "tests")
import _torch_train as T
import test_torch_train_sharded as S
from repro_torch import convert
from repro_torch.optim import AdamW, wsd_schedule
from repro_torch.train import sharded

mesh = mesh_of(S.MESH)
for case, (arch, ga) in S.CASES.items():
    cfg = S.config(arch)
    opt = AdamW(lr=wsd_schedule(*S.LR), weight_decay=0.01)
    state = convert.train_state_from_numpy(cfg, S.numpy_state(cfg),
                                           device="cpu", mesh=mesh)
    rows = sharded.batch_rows(S.global_batch(cfg), mesh, ga)
    step = sharded.make_sharded_train_step(cfg, opt, mesh, grad_accum=ga)
    state, m = step(state, {{k: torch.from_numpy(v) for k, v in rows.items()}})
    res.update({{f"{{case}}/metrics/{{k}}": v.numpy() for k, v in m.items()}})
    got = convert.train_state_to_numpy(state)
    if rank == 0:
        res.update(T.flat(got, f"{{case}}/state/"))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, "train_sharded", 8, _PORT)


def _one_device(case):
    """The port's one-device step on the global batch: (metrics, flat
    state)."""
    arch, ga = CASES[case]
    cfg = config(arch)
    opt = AdamW(lr=wsd_schedule(*LR), weight_decay=0.01)
    state = convert.train_state_from_numpy(cfg, numpy_state(cfg),
                                           device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in global_batch(cfg).items()}
    state, m = make_train_step(cfg, opt, grad_accum=ga)(state, batch)
    return ({k: v.numpy() for k, v in m.items()},
            flat(convert.train_state_to_numpy(state)))


def _assert_metrics(got: dict, want: dict, label):
    assert got.keys() == want.keys(), (label, got.keys(), want.keys())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{label} {k}")


def _assert_state(got: dict, want: dict, label):
    """One step from the same state: count and step equal; the moments
    within 1e-5 of each leaf's scale; the parameters and master weights
    within 1e-3 x lr at 99.9% of the elements and 2 x lr everywhere."""
    lr = float(wsd_schedule(*LR)(1))
    assert got.keys() == want.keys(), (label, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k in ("opt/count", "step"):
            assert g == w, (label, k)
            continue
        err = np.abs(g - w)
        if k.startswith(("opt/m/", "opt/v/")):
            bound = 1e-5 * np.abs(w).max()
            assert err.max() <= bound, f"{label} {k}: {err.max():.3e}"
            continue
        assert err.max() <= 2 * lr, f"{label} {k}: {err.max():.3e}"
        q = np.quantile(err, 0.999)
        assert q <= 1e-3 * lr, f"{label} {k}: 99.9% {q:.3e}"


def _case(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_reference_2x4(reference, ranks, case):
    """The 2x4 step's metrics (on every rank) and gathered state against
    the reference's executed 2x4 step."""
    want_m = _case(reference, f"{case}/metrics/")
    for r, res in enumerate(ranks):
        _assert_metrics(_case(res, f"{case}/metrics/"), want_m,
                        f"{case} rank {r}")
    _assert_state(_case(ranks[0], f"{case}/state/"),
                  _case(reference, f"{case}/state/"), case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_device(ranks, case):
    """The 2x4 step against the port's one-device step on the global
    batch: the same metrics (grad_norm too) and state within the
    tolerances."""
    want_m, want_state = _one_device(case)
    _assert_metrics(_case(ranks[0], f"{case}/metrics/"), want_m, case)
    _assert_state(_case(ranks[0], f"{case}/state/"), want_state, case)


def test_ranks_agree(ranks):
    """Every rank reports the same metrics, bit for bit (the reduced sums
    are the same on every rank)."""
    for res in ranks[1:]:
        for k, v in ranks[0].items():
            if "/metrics/" in k:
                np.testing.assert_array_equal(res[k], v, err_msg=k)
