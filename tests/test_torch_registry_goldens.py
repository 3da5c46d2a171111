"""The goldens that ``chip_smoke.py`` holds the port against on the card,
against the recipe that made them: the f32 goldens of gemma-2b, minicpm-2b,
starcoder2-7b, qwen2-vl-72b and dbrx-132b, and the bf16 twins of every
registry arch's f32 golden but qwen2-0.5b's (``tests/test_torch_lm.py``
checks that one).

Each was made by the JAX package at full width and a cut depth from
``convert.numpy_lm_leaves(cfg, seed=0)`` (``tests/fixtures/make_*_golden.py``):
every leaf's path, shape and float64 sum must still come out of the recipe,
leaf by leaf (at most one leaf at a time: qwen2-vl-72b's embedding and head,
1.25 B values each, are the largest), and the arrays have the recipe's
shapes (a batch of 2, a 300-token prompt (deepseek-v2-lite's 64, whisper's
75 after 150 frames), 3 decode steps, the top 40 of each row; a MoE golden's
routing of the prefill and of each decode step). A bf16 golden has its f32
twin's seed, depth, prompt and tokens; its sums are those of each leaf in
the dtype the reference's ``lm.init`` gives it (float32 for a MoE router and
Mamba2's ``A_log``, ``D`` and ``dt_bias``, bf16 otherwise), rounded to
nearest even as the port rounds it (the makers' ``leaf_sum``). One walk of
the recipe serves both twins. The sums are compared exactly: the recipe is
deterministic. Also ``convert.lm_params_from_recipe``, which draws the
recipe straight into a model (qwen2-vl-72b's and dbrx-132b's goldens on the
card), against the tree it draws.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch import convert
from repro_torch.configs import get_config

FIXTURES = Path(__file__).parent / "fixtures"
_spec = importlib.util.spec_from_file_location(
    "make_golden", FIXTURES / "make_mamba2_130m_golden.py")
_maker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_maker)


def _fixture(arch, dtype):
    suffix = "" if dtype == "float32" else "_bf16"
    stem = {"deepseek-v2-lite-16b": "deepseek_v2_lite"}.get(
        arch, arch.replace("-", "_").replace(".", "_"))
    return np.load(FIXTURES / f"{stem}_golden{suffix}.npz")


def _check_arrays(g, arch, dtype, layers, prompt):
    """The golden's scalars and its arrays' shapes."""
    assert str(g["arch"]) == arch and str(g["dtype"]) == dtype
    assert int(g["seed"]) == 0 and int(g["layers"]) == layers
    cfg = get_config(arch)
    steps, b, p = 4, 2, int(g["prompt_len"])
    assert p == prompt and int(g["topk"]) == 32
    assert g["tokens"].shape == (b, p + steps - 1)
    assert ((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    assert (g["top_idx"] < cfg.vocab_size).all()     # never a pad column
    assert g["lse"].shape == g["rms"].shape == (steps, b)
    assert np.isfinite(g["top_val"]).all() and (g["rms"] > 0).all()
    assert (np.diff(g["top_val"], axis=-1) <= 0).all()
    if "route_idx" in g.files:
        m, k = cfg.moe, cfg.moe.top_k
        n = sum(cfg.block_kind(i) == "moe" for i in range(layers))
        assert g["route_idx"].shape == (n, b, p, k)
        assert g["route_prob"].shape == (n, b, p, k + 1)
        assert g["route_keep"].shape == (n, b, p * k)
        assert g["route_cut_gap"].shape == (n, b, m.num_experts)
        assert int(g["moe_dropped"]) == int((~g["route_keep"]).sum())
        assert ((g["route_idx"] >= 0) & (g["route_idx"] < m.num_experts)).all()


def _walk(arch, layers, twins):
    """One walk of the recipe at ``arch``'s full width cut to ``layers``,
    each leaf held to every golden of ``twins`` (dtype -> fixture)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    want = {}
    if "bfloat16" in twins:
        want = _maker.reference_dtypes(dataclasses.replace(
            ref_config(arch), num_layers=layers, dtype="bfloat16"))
    leaves = {dtype: list(zip(g["leaf_paths"], g["leaf_shapes"],
                              g["leaf_sums"])) for dtype, g in twins.items()}
    n = 0
    for i, (rpath, x) in enumerate(convert.numpy_lm_leaves(cfg, 0)):
        name = "/".join(map(str, rpath))
        for dtype, g in twins.items():
            path, shape, total = leaves[dtype][i]
            assert path == name and shape == ",".join(map(str, x.shape))
            kind = want[name] if dtype == "bfloat16" else "float32"
            if "leaf_dtypes" in g.files:
                assert str(g["leaf_dtypes"][i]) == kind, path
            assert _maker.leaf_sum(x, kind) == total, (dtype, path)
        n += 1
        del x
    for dtype in twins:
        assert len(leaves[dtype]) == n, dtype


@pytest.mark.parametrize("arch,layers", [("gemma-2b", 4), ("minicpm-2b", 8),
                                         ("starcoder2-7b", 2)])
def test_golden_fixture_matches_recipe(arch, layers):
    """The f32 golden and its bf16 twin, in one walk of the recipe."""
    f32, bf16 = _fixture(arch, "float32"), _fixture(arch, "bfloat16")
    _check_arrays(f32, arch, "float32", layers, 300)
    _check_arrays(bf16, arch, "bfloat16", layers, 300)
    np.testing.assert_array_equal(bf16["tokens"], f32["tokens"])
    _walk(arch, layers, {"float32": f32, "bfloat16": bf16})


#: The other archs' bf16 twins (their f32 goldens are checked by
#: test_torch_lm.py, test_torch_hybrid.py and test_torch_encdec.py), and
#: qwen2-vl-72b's and dbrx-132b's f32 goldens with their twins: arch ->
#: (depth, prompt, whether the f32 golden is checked in the same walk).
#: The last two walk ~4.3-4.5 B values each (~100 s alone), so each has a
#: file of its own (``test_torch_registry_goldens_<arch>.py``), which the
#: test runner's workers take in parallel.
TWINS = {"deepseek-v2-lite-16b": (2, 64, False), "mamba2-130m": (24, 300, False),
         "zamba2-7b": (7, 300, False), "whisper-large-v3": (32, 75, False),
         "qwen2-vl-72b": (2, 300, True), "dbrx-132b": (1, 300, True)}
BIG = ("qwen2-vl-72b", "dbrx-132b")


@pytest.mark.parametrize("arch", [a for a in TWINS if a not in BIG])
def test_bf16_twin_matches_recipe(arch):
    check_twins(arch)


def check_twins(arch):
    """``arch``'s bf16 golden (and, where TWINS says so, its f32 golden)
    against the recipe, in one walk."""
    layers, prompt, here = TWINS[arch]
    f32, bf16 = _fixture(arch, "float32"), _fixture(arch, "bfloat16")
    for key in ("seed", "layers", "prompt_len", "tokens", "leaf_paths",
                "leaf_shapes"):
        np.testing.assert_array_equal(bf16[key], f32[key], err_msg=key)
    _check_arrays(bf16, arch, "bfloat16", layers, prompt)
    _check_arrays(f32, arch, "float32", layers, prompt)
    if "frames_len" in f32.files:                   # whisper's inputs
        assert float(bf16["frames_sum"]) == float(f32["frames_sum"])
    if "route_idx" in bf16.files:                   # each decode step's routing
        k = get_config(arch).moe.top_k
        n, b = bf16["route_idx"].shape[:2]
        assert bf16["step_route_idx"].shape == (3, n, b, 1, k)
        assert bf16["step_route_prob"].shape == (3, n, b, 1, k + 1)
        assert bf16["step_route_keep"].all()
    _walk(arch, layers, {"float32": f32, "bfloat16": bf16} if here
          else {"bfloat16": bf16})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "zamba2-7b", "whisper-large-v3",
                                  "dbrx-132b"])
def test_recipe_loader_equals_tree_loader(arch, dtype):
    """``convert.lm_params_from_recipe`` (each leaf copied as it is drawn;
    the card's loader of qwen2-vl-72b's and dbrx-132b's goldens) gives the
    parameters of ``lm_params_from_numpy`` of the recipe's tree, bit for bit
    and dtype for dtype, at depth 1 too (a stacked leaf of one layer)."""
    for layers in (None, 1):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        if layers and cfg.encdec is None and cfg.ssm is None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        got = dict(convert.lm_params_from_recipe(
            cfg, 3, device="cpu", threads=2).named_parameters())
        want = dict(convert.lm_params_from_numpy(
            cfg, convert.numpy_lm_params(cfg, 3), device="cpu").named_parameters())
        assert got.keys() == want.keys()
        for name, p in want.items():
            assert got[name].dtype == p.dtype and torch.equal(got[name], p), name
