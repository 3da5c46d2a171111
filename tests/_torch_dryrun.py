"""Shared pieces of the dry-run tests: the reference's records
(``tests/fixtures/dryrun_reference.json``, made by
``tests/fixtures/make_dryrun_reference.py``) and the check of one of the
port's cell records against them."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch import dryrun

FIXTURE = json.loads((Path(__file__).parent / "fixtures"
                      / "dryrun_reference.json").read_text())


def smoke_config(arch: str):
    """The arch's smoke config with the fixture's chunks (those of the
    reference's compiled cells)."""
    chunks = FIXTURE["smoke_chunks"]
    cfg = get_config(arch, smoke=True)
    ssm = (None if cfg.ssm is None else
           dataclasses.replace(cfg.ssm, chunk=chunks["ssm_chunk"]))
    return dataclasses.replace(cfg, attn_chunk=chunks["attn_chunk"],
                               loss_chunk=chunks["loss_chunk"], ssm=ssm)


def cells(archs) -> list:
    """The fixture's smoke cells of ``archs``, as ``arch__shape__mesh``."""
    return sorted(k for k in FIXTURE["cells"] if k.split("__")[0] in archs)


def check_cell(key: str) -> dict:
    """The port's record of smoke cell ``key`` against the reference's:
    status and reason, chips, tokens and ``model_flops_total`` equal, and
    ``argument_size_in_bytes`` equal to the byte once the inputs the
    reference's executable dropped as unread are added back."""
    arch, shape, mesh = key.split("__")
    want = FIXTURE["cells"][key]
    cfg = smoke_config(arch)
    rec = dryrun.run_cell(arch, shape, mesh, cfg_override=cfg, device="cpu")
    assert rec["status"] == want["status"], rec.get("traceback", rec)
    assert rec.get("reason") == want.get("reason")
    assert dryrun._tokens(cfg, shape) == want["tokens"]
    if want["status"] != "OK":
        return rec
    assert rec["chips"] == want["chips"]
    assert rec["roofline"]["model_flops_total"] == want["model_flops_total"]
    assert rec["memory"]["argument_size_in_bytes"] == (
        want["memory"]["argument_size_in_bytes"]
        + want["pruned_argument_bytes"])
    walk = rec["hlo_walk"]
    assert walk["flops"] > 0 and walk["bytes"] > 0
    assert walk["unknown_trips"] == []
    assert rec["collectives"]["total_count"] == walk["collective_count"]
    return rec
