"""The f32 goldens of gemma-2b, minicpm-2b and starcoder2-7b, which
``chip_smoke.py`` holds the port against on the card, against the recipe
that made them.

Each was made by the JAX package at full width and a cut depth from
``convert.numpy_lm_params(cfg, seed=0)`` (``tests/fixtures/make_*_golden.py``):
every leaf's path, shape and float64 sum must still come out of the recipe,
leaf by leaf (at most one leaf at a time: gemma-2b's tied embedding, 524 M
values, is the largest), and the arrays have the recipe's shapes (a batch of
2, a 300-token prompt, 3 decode steps, the top 40 of each row). The sums are
compared exactly: the recipe is deterministic.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import get_config

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.mark.parametrize("arch,layers", [("gemma-2b", 4), ("minicpm-2b", 8),
                                         ("starcoder2-7b", 2)])
def test_golden_fixture_matches_recipe(arch, layers):
    g = np.load(FIXTURES / f"{arch.replace('-', '_')}_golden.npz")
    assert str(g["arch"]) == arch and str(g["dtype"]) == "float32"
    assert int(g["seed"]) == 0 and int(g["layers"]) == layers
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    steps, b, p = 4, 2, int(g["prompt_len"])
    assert p == 300 and int(g["topk"]) == 32
    assert g["tokens"].shape == (b, p + steps - 1)
    assert ((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()
    assert g["top_idx"].shape == g["top_val"].shape == (steps, b, 40)
    assert (g["top_idx"] < cfg.vocab_size).all()     # never a pad column
    assert g["lse"].shape == g["rms"].shape == (steps, b)
    assert np.isfinite(g["top_val"]).all() and (g["rms"] > 0).all()
    assert (np.diff(g["top_val"], axis=-1) <= 0).all()
    leaves = list(zip(g["leaf_paths"], g["leaf_shapes"], g["leaf_sums"]))
    recipe = convert.numpy_lm_leaves(cfg, int(g["seed"]))
    for (path, shape, total), (rpath, x) in zip(leaves, recipe, strict=True):
        assert path == "/".join(map(str, rpath))
        assert shape == ",".join(map(str, x.shape))
        assert x.sum(dtype=np.float64) == total, path
