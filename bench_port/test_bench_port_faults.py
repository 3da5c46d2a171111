"""CPU tests that drive whole runs of the harness on a tiny copy of each
cell (the same traffic mixes, the arrow-LU graph cut to 2 blocks on a 2x2
grid, on the port's CPU path): a sound run is correct; the control (the
reference in bfloat16 in the program's place) and each fault a cell can
have (a step that leaves the state as it was, a token altered where the ALU
makes it) come out not correct. Half of a batch left out does not arise
(every call is one simulation), nor does the exchange between chips (every
cell takes one chip)."""
from __future__ import annotations

import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in MANIFEST["workloads"])


def tiny_bench(d: Path) -> dict:
    """A copy of the manifest in ``d`` whose configurations are the arrow-LU
    graph of 2 blocks of 3 and a border of 2 on a 2x2 grid, with the cells'
    traffic (one call a traced slice)."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (d / "traffic").mkdir(parents=True, exist_ok=True)
    for entry in manifest["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        config["graph"] = dict(config["graph"], blocks=2, block_size=3,
                               border=2)
        config["grid"] = {"nx": 2, "ny": 2}
        entry["file"] = f"{entry['name']}.json"
        (d / entry["file"]).write_text(json.dumps(config))
    for w in manifest["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        mix["trace_calls"] = 1
        (d / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    return manifest


@pytest.fixture
def bench(tmp_path, monkeypatch):
    from bench_port import harness

    manifest = tiny_bench(tmp_path)
    # Other test files of this process load JAX; a fresh process holds the
    # harness to loading none (test_bench_port_manifest.py).
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(cell, seed=123456789012, trace=False):
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run(manifest, cell, seed, 0.01, trace, base=tmp_path,
                         t_start=time.perf_counter(), device="cpu",
                         traffic_dir=tmp_path / "traffic", out=out, err=err)
        assert rc == 0, err.getvalue()
        return json.loads(out.getvalue().splitlines()[-1])

    return run


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    res = bench(cell)
    assert res["correct"], res
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s", "sim_cycles_per_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_reads_the_host_layer(bench):
    res = bench("fig1-n29772.select-solo", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"host_ir_setup_s"}
    assert res["device"]["window_s"] > 0
    # Two slices of one call each: the device's and the host's.
    assert res["attempted"] == 2
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _reference_in_place(monkeypatch, dtype):
    """``repro_torch.run`` replaced by the plain reference: its cycles and
    counters, and node values evaluated in ``dtype``."""
    import repro_torch

    from bench_port import overlay_ref
    from repro_torch.core.overlay import SimResult

    def fake(gm, cfg, *, device=None):
        # The tiny graph's structure and values, read back off the packing.
        n = gm.num_nodes
        ops = gm.opcode[gm.node_pe, gm.node_slot].astype(np.int8)
        vals = gm.init_value[gm.node_pe, gm.node_slot]
        struct = _tiny_struct()
        assert n == struct["opcode"].size and (ops == struct["opcode"]).all()
        prep = overlay_ref.prepare(struct)
        layout = "criticality" if cfg.scheduler == "ooo" else "fifo"
        sim, = overlay_ref.simulate(struct, prep, gm.nx, gm.ny, [dict(
            scheduler=cfg.scheduler, layout=layout,
            select_latency=cfg.select_latency or 1)])
        values = overlay_ref.evaluate(struct, prep, vals, dtype=dtype)
        return SimResult(values=values, **sim)

    monkeypatch.setattr(repro_torch, "run", fake)


def _tiny_struct():
    from bench_port import arrow_lu

    return arrow_lu.structure(2, 3, 2)


@pytest.mark.parametrize("dtype,correct", [("float32", True),
                                           ("bfloat16", False)])
def test_control_in_lower_precision_fails(bench, monkeypatch, dtype, correct):
    import torch

    _reference_in_place(monkeypatch, getattr(torch, dtype))
    res = bench("fig1-n470772.mk-solo")
    assert res["correct"] is correct, res["checks"]
    assert (res["checks"]["values_wrong"]["value"] > 0) is not correct


def _state_unchanged(monkeypatch):
    from repro_torch.core import overlay

    monkeypatch.setattr(overlay, "make_engine_chunk_fn",
                        lambda *a, **k: (lambda s, *x, **y: s))
    monkeypatch.setattr(overlay, "make_cycle_fn",
                        lambda *a, **k: (lambda s: s))


def _token_altered(monkeypatch):
    from repro_torch.core import overlay
    from repro_torch.core.graph import OP_MUL

    exact = overlay.alu
    monkeypatch.setattr(overlay, "alu", lambda op, a, b: exact(op, a, b)
                        + (op == OP_MUL) * 2.0 ** -10)


FAULTS = {"state_unchanged": _state_unchanged,
          "token_altered": _token_altered}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS])
def test_fault_is_not_correct(bench, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = bench(cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0 or res["checks"]["values_wrong"]["value"] > 0


def test_control_script_reads_the_lower_precision():
    from bench_port import control

    config = {"graph": {"blocks": 2, "block_size": 3, "border": 2}}
    (seed, low, again, n), = control.readings(config, [5])
    assert seed == 5 and again == 0 and 0 < low <= n


def test_no_card_means_no_result(monkeypatch, capsys):
    import importlib.util

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location("bench_port_run_cli",
                                                  HERE / "run.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    rc = cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
