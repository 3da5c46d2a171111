"""The port's checkpoints (``repro_torch.checkpoint.manager``): the
reference's own cases (``tests/test_checkpoint.py``: round trip and
``keep_n`` cleanup, async save, a template that does not match, resume
exactness), and the two packages reading each other's checkpoints.

A train state is written in the reference's flatten order and shapes, so
each package restores the other's float32 train states leaf for leaf, bit
for bit: the port's (after a step) restored by the reference, the
reference's (after a step) restored by the port, for a dense, a hybrid
(a shared block, ``None`` segments) and an encoder-decoder smoke config.
bfloat16 leaves go to disk as the reference writes them (2-byte void,
``"dtype": "bfloat16"``): the port reads back its own and the reference's
bit for bit, and the reference's restore returns the port's as the void
array that ``.view(ml_dtypes.bfloat16)`` turns into the same values.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_ref import run_reference
from _torch_train import flat
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticCopyTask
from repro_torch.optim import AdamW
from repro_torch.train.steps import init_train_state, make_train_step

CROSS_ARCHS = ("qwen2-0.5b", "zamba2-7b", "whisper-large-v3")
BF16_TREE_SEED = 3


def cross_batch(cfg):
    import _torch_train
    return _torch_train.lm_batch(cfg, batch=2, seq=9, seed=4)


def bf16_values():
    """Float32 values exactly representable in bfloat16."""
    rng = np.random.default_rng(BF16_TREE_SEED)
    x = rng.standard_normal((3, 5), dtype=np.float32)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def port_state_after_a_step(arch):
    """The port's train state of the smoke config after one step from the
    numpy recipe's weights (AdamW, master weights)."""
    cfg = get_config(arch, smoke=True)
    model = convert.lm_params_from_numpy(cfg, convert.numpy_lm_params(cfg, 1),
                                         device="cpu").requires_grad_(True)
    opt = AdamW(lr=1e-3)
    state = {"params": model, "opt": opt.init(model),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in cross_batch(cfg).items()}
    state, _ = make_train_step(cfg, opt)(state, batch)
    return state


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port's checkpoints for the reference to read: each arch's train
    state, and a bfloat16 tree."""
    root = tmp_path_factory.mktemp("port_ckpt")
    states = {}
    for arch in CROSS_ARCHS:
        states[arch] = port_state_after_a_step(arch)
        ckpt.save(str(root / arch), 1, states[arch])
    ckpt.save(str(root / "bf16"), 2, {
        "b": torch.from_numpy(bf16_values()).to(torch.bfloat16),
        "a": torch.arange(4, dtype=torch.int32)})
    return root, states


@pytest.fixture(scope="module")
def reference(tmp_path_factory, written):
    root, _ = written
    out = tmp_path_factory.mktemp("ref_ckpt")
    return out, run_reference(tmp_path_factory, "train_checkpoint", f"""
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
import ml_dtypes
import _torch_train as T
import test_torch_train_checkpoint as C
from repro.checkpoint import manager
from repro.configs import get_config
from repro.optim import AdamW
from repro.train.steps import make_train_step
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_params

for arch in C.CROSS_ARCHS:
    cfg = get_config(arch, smoke=True)
    opt = AdamW(lr=1e-3)
    params = jax.tree.map(jnp.asarray,
                          numpy_lm_params(port_config(arch, smoke=True), 1))
    state = {{"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}}
    # the port's checkpoint, restored into the reference's structure
    back = manager.restore({str(root)!r} + "/" + arch, state)
    for k, v in T.flat(back, f"{{arch}}/port_read_by_reference/").items():
        res[k] = v
    # the reference's own state after a step, written for the port
    batch = {{k: jnp.asarray(v) for k, v in C.cross_batch(cfg).items()}}
    state, _ = jax.jit(make_train_step(cfg, opt))(state, batch)
    manager.save({str(out)!r} + "/" + arch, 1, state)
    res.update(T.flat(state, f"{{arch}}/reference_state/"))

b = manager.restore({str(root)!r} + "/bf16", {{"a": 0, "b": 0}})
res["bf16/port_read_by_reference/kind"] = np.array(b["b"].dtype.str)
res["bf16/port_read_by_reference/b"] = b["b"].view(ml_dtypes.bfloat16).astype(np.float32)
res["bf16/port_read_by_reference/a"] = b["a"]
manager.save({str(out)!r} + "/bf16", 2, {{
    "b": jnp.asarray(C.bf16_values()).astype(jnp.bfloat16),
    "a": jnp.arange(4, dtype=jnp.int32)}})
""")


def test_roundtrip_and_gc(tmp_path):
    cm = ckpt.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3))}}
    for s in (1, 2, 3):
        cm.save(s, tree)
    assert cm.latest_step() == 3
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2  # GC kept last 2
    back = cm.restore_latest(tree)
    assert back.keys() == tree.keys() and back["b"].keys() == {"c"}
    for x, y in ((tree["a"], back["a"]), (tree["b"]["c"], back["b"]["c"])):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["paths"] == ["a", "b/c"] and manifest["num_leaves"] == 2


def test_async_save(tmp_path):
    cm = ckpt.CheckpointManager(str(tmp_path), keep_n=3, async_save=True)
    tree = {"w": torch.zeros(10)}
    cm.save(5, tree)
    cm.wait()
    assert cm.latest_step() == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    # A save that fails in the writer thread (a file where its temporary
    # directory goes) raises at the next wait, once.
    (tmp_path / "step_00000006.tmp").write_text("a file, not a directory")
    cm.save(6, tree)
    with pytest.raises(NotADirectoryError):
        cm.wait()
    cm.wait()
    assert cm.latest_step() == 5


def test_no_partial_checkpoint_on_restore_error(tmp_path):
    cm = ckpt.CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        cm.restore_latest({"a": torch.zeros(3), "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        cm.restore_latest({"a": torch.zeros(4)})


def test_training_resume_exactness(tmp_path):
    """Crash/restart: restoring the checkpoint and replaying the
    deterministic data stream reproduces the uninterrupted run exactly (the
    reference's test, on the port's train state)."""
    cfg = get_config("minicpm-2b", smoke=True)
    opt = AdamW(lr=1e-3)
    ds = SyntheticCopyTask(cfg.vocab_size, batch=8, seq=16, seed=1)
    step = make_train_step(cfg, opt)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}

    state = init_train_state(torch.Generator("cpu").manual_seed(0), cfg, opt)
    for i in range(4):
        state, _ = step(state, batch(i))
    cm = ckpt.CheckpointManager(str(tmp_path), async_save=False)
    cm.save(4, state)
    saved = convert.train_state_to_numpy(state)
    for i in range(4, 8):
        state, _ = step(state, batch(i))

    resumed = cm.restore_latest(state)
    for k, v in flat(convert.train_state_to_numpy(resumed)).items():
        np.testing.assert_array_equal(v, flat(saved)[k], err_msg=k)
    assert all(p.requires_grad for p in resumed["params"].parameters())
    for i in range(4, 8):
        resumed, _ = step(resumed, batch(i))
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert int(resumed["step"]) == 8


def test_bfloat16_train_state_round_trips_bit_for_bit(tmp_path):
    """A bfloat16 model (float32 router and master weights beside it):
    every leaf restored with its dtype and its bits; the manifest names the
    bfloat16 leaves as the reference does."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              dtype="bfloat16")
    state = init_train_state(torch.Generator("cpu").manual_seed(2), cfg,
                             AdamW())
    ckpt.save(str(tmp_path), 3, state)
    back = ckpt.restore(str(tmp_path), state)
    want = convert.train_state_tree(state)
    got = convert.train_state_tree(back)
    for (p, a), (q, b) in zip(ckpt._flatten_with_paths(want),
                              ckpt._flatten_with_paths(got)):
        assert p == q and a.dtype == b.dtype, p
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)), p
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    kinds = dict(zip(manifest["paths"],
                     (x["dtype"] for x in manifest["leaves"])))
    assert kinds["params/embed"] == "bfloat16"
    assert kinds["params/segments/1/ffn/router/w"] == "float32"
    assert kinds["opt/master/embed"] == "float32"
    assert kinds["step"] == "int32"


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_reference_restores_the_ports_train_state(reference, written, arch):
    _, states = written
    _, ref = reference
    got = flat(convert.train_state_to_numpy(states[arch]))
    prefix = f"{arch}/port_read_by_reference/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_restores_the_references_train_state(reference, written, arch):
    out, ref = reference
    _, states = written
    back = ckpt.CheckpointManager(str(out / arch)).restore_latest(states[arch])
    got = flat(convert.train_state_to_numpy(back))
    prefix = f"{arch}/reference_state/"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(back["step"]) == 1 and int(back["opt"]["count"]) == 1


def test_bfloat16_leaves_both_ways(reference, written):
    out, ref = reference
    root, _ = written
    vals = bf16_values()
    assert str(ref["bf16/port_read_by_reference/kind"]) == "|V2"
    np.testing.assert_array_equal(ref["bf16/port_read_by_reference/b"], vals)
    np.testing.assert_array_equal(ref["bf16/port_read_by_reference/a"],
                                  np.arange(4, dtype=np.float32))
    template = {"a": torch.zeros(4, dtype=torch.int32),
                "b": torch.zeros(3, 5, dtype=torch.bfloat16)}
    for path in (root / "bf16", out / "bf16"):
        back = ckpt.restore(str(path), template)
        assert back["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(back["b"].float().numpy(), vals)
        assert back["a"].dtype == torch.int32
        np.testing.assert_array_equal(back["a"].numpy(), np.arange(4))
