"""The dry-run at full size without running a step, and its command line.

  * every arch's full config x every shape x both production meshes: the
    status and reason (``shape_applicable``), ``_tokens``,
    ``model_flops_total`` and the rank's argument bytes, summed from the
    specs' block shapes (``dryrun.argument_bytes`` on a stand-in mesh),
    equal the reference's (``tests/fixtures/dryrun_reference.json``'s
    ``full`` records, summed from its ``NamedSharding`` shard shapes);
  * ``argument_bytes`` is what ``run_cell`` records, on a smoke cell;
  * ``main`` writes one record a cell, skips it when it exists, redoes it
    with ``--force``, and without a card raises unless ``--device cpu``.
"""
import json

import pytest
import torch

from _torch_dryrun import FIXTURE, smoke_config
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.models import lm


@pytest.mark.parametrize("key", sorted(FIXTURE["full"]))
def test_full_size_cell_matches_reference(key):
    arch, shape, mesh = key.split("__")
    want = FIXTURE["full"][key]
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    assert ("OK" if ok else "SKIP", reason) == (want["status"], want["reason"])
    tokens = dryrun._tokens(cfg, shape)
    assert tokens == want["tokens"]
    mf = 6 if SHAPES[shape].kind == "train" else 2
    assert mf * lm.active_param_count(cfg) * tokens == want["model_flops_total"]
    if ok:
        assert dryrun.argument_bytes(cfg, shape, dryrun.mesh_shape(mesh)) \
            == want["argument_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_bytes_is_the_recorded_size(shape):
    cfg = smoke_config("qwen2-0.5b")
    rec = dryrun.run_cell("qwen2-0.5b", shape, "multi", cfg_override=cfg,
                          device="cpu", want_profile=True)
    assert rec["memory"]["argument_size_in_bytes"] == dryrun.argument_bytes(
        cfg, shape, dryrun.mesh_shape("multi"))
    assert rec["route"] == "fake, host tensors"
    prof = rec["profile"]
    assert 0 < len(prof) <= 25
    assert sum(v["bytes"] for v in prof.values()) <= rec["hlo_walk"]["bytes"]
    if shape == "decode_32k":          # kernel 5 charged under its layer
        assert any(k.endswith("attn/flash_attention") for k in prof), \
            sorted(prof)


def test_main_writes_resumes_and_needs_a_device(tmp_path, capsys,
                                                monkeypatch):
    args = ["--arch", "mamba2-130m", "--shape", "decode_32k", "long_500k",
            "--mesh", "single", "--out", str(tmp_path), "--device", "cpu"]
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: smoke_config(arch))
    dryrun.main(args)
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert sorted(recs) == ["mamba2-130m__decode_32k__single.json",
                            "mamba2-130m__long_500k__single.json"]
    assert all(r["status"] == "OK" for r in recs.values())
    assert "--- OK" in capsys.readouterr().out
    dryrun.main(args)
    assert capsys.readouterr().out.count("skip (exists)") == 2
    dryrun.main(args[:4] + ["--mesh", "single", "--out", str(tmp_path),
                            "--device", "cpu", "--force"])
    assert "=== mamba2-130m x decode_32k x single ===" in \
        capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(args[:-2])
