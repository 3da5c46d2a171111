"""The port's training step held to the JAX package's full-width golden
(``tests/fixtures/qwen2_0_5b_train_golden.npz``, made by
``make_qwen2_0_5b_train_golden.py``) at depth 2 on the CPU, through the
functions ``chip_smoke.py``'s phase 20b runs at full depth on the card:
qwen2-0.5b at full width in f32 with the numpy recipe's weights and the
golden's copy-task batch; the loss, its metrics, the gradient's global and
per-leaf norms, sliced gradients and the sliced weights after one AdamW
step at ``chip_smoke.TRAIN_GOLDEN_TOL``; then ``grad_accum=2`` against the
full batch at the reference test's thresholds (``TRAIN_ACCUM_TOL``), with
the gradients, and with the elements whose gradient is below ten times
AdamW's eps held to one step's size (``chip_smoke.train_accum``).
~4 GB and ~30 s on the CPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "qwen2_0_5b_train_golden.npz"


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden_run(cs):
    g = np.load(GOLDEN)
    err, tree = cs.train_golden(torch, np, "cpu", g, "small_")
    return g, err, tree


def test_the_golden_is_the_configuration_phase_20b_runs(cs):
    g = np.load(GOLDEN)
    assert str(g["arch"]) == "qwen2-0.5b"
    assert (int(g["layers"]), int(g["small_layers"])) == (24, 2)
    assert (int(g["batch"]), int(g["seq"]), float(g["lr"])) == (2, 64, 1e-3)
    assert g["batch_tokens"].shape == (2, 63)
    assert cs.TRAIN_GOLDEN == GOLDEN


def test_port_matches_the_golden_at_depth_2(cs, golden_run):
    _, err, _ = golden_run
    tol = cs.TRAIN_GOLDEN_TOL
    assert set(err) == {"loss", "xent", "leaf_norm", "grad", "grad_norm",
                        "new"}
    for k, v in err.items():
        assert v <= tol["loss" if k == "xent" else k], (k, v)


def test_grad_accum_matches_the_full_batch_at_depth_2(cs, golden_run):
    g, _, tree = golden_run
    loss_rel, ratio, tiny, m_err = cs.train_accum(torch, np, "cpu", tree,
                                                  int(g["small_layers"]))
    assert loss_rel <= cs.TRAIN_ACCUM_TOL["loss"] and ratio <= 1
    assert m_err <= 1e-5 and 0 < tiny
