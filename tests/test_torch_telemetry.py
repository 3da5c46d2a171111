"""The port's telemetry (``repro_torch.telemetry``) against the reference's
``repro.telemetry``, on the CPU: the spec and its validation, the bucket
clamp and partial specs, ``report()`` and the Perfetto export, the batched
engines (every element equal to its solo run and to the reference's batch),
the n15072 ``telemetry`` goldens of ``BENCH_overlay.json``, the CLI, and the
megakernel's leaf check of a traced state.
"""
import json
from pathlib import Path

import pytest

from _torch_ref import (BATCH_POLICIES, ROOT, assert_telemetry_matches,
                        assert_traces_equal, port_telemetry_run,
                        run_reference, telemetry_cell, telemetry_reference)

import repro_torch
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.telemetry import TelemetrySpec
from repro_torch.telemetry.perfetto import track_count

#: Cells beyond the matrix files' spec: the bucket clamp (4 x 8 = 32 cycles
#: of a ~1,400-cycle run), one bucket a cycle, and specs with groups off.
CLAMP = telemetry_cell("ooo", "n_first_cap1", dict(buckets=4, bucket_cycles=8))
PER_CYCLE = telemetry_cell("inorder", "cap2",
                           dict(buckets=1600, bucket_cycles=1))
PARTIAL = [
    telemetry_cell("ooo", "priority_cap1",
                   dict(buckets=8, bucket_cycles=32, links=False,
                        eject=False, sched=False)),
    telemetry_cell("lru_flat", "n_first_cap1",
                   dict(buckets=8, bucket_cycles=32, pe=False, stalls=False)),
    telemetry_cell("inorder", "priority_cap1",
                   dict(buckets=8, bucket_cycles=32, pe=False, links=False,
                        eject=False, sched=False)),
]
REPORTED = telemetry_cell("ooo", "n_first_cap1")
#: A budget that stops the run mid-way: the traces of the cycles run.
BUDGET = telemetry_cell("scan", "cap2", budget=300)
CELLS = [CLAMP, PER_CYCLE, *PARTIAL, REPORTED, BUDGET]

#: The batched case: ``layered_dag(4, 6, seed=3)`` on 2x2, every policy run
#: to completion (elements finish at different cycles and run on done) and
#: ``scan`` frozen at 20 cycles.
BATCH_SPEC = dict(buckets=16, bucket_cycles=8)
BATCH_CFGS = [*(dict(scheduler=p, max_cycles=100_000) for p in BATCH_POLICIES),
              dict(scheduler="scan", max_cycles=20),
              dict(scheduler="ooo", select_latency=4, max_cycles=100_000)]

#: Specs whose derived values are held to the reference's.
SPECS = [dict(), dict(buckets=3, bucket_cycles=5), dict(pe=False),
         dict(links=False, stalls=False), dict(sched=False, eject=False)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return telemetry_reference(tmp_path_factory, "telemetry_cases", CELLS)


@pytest.fixture(scope="module")
def batch_reference(tmp_path_factory):
    body = f"""
    import repro
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory
    from repro.telemetry import TelemetrySpec

    gm = build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2,
                            criticality_order=True)
    spec = TelemetrySpec(**{BATCH_SPEC!r})
    cfgs = [OverlayConfig(check_every=1, telemetry=spec, **kw)
            for kw in {BATCH_CFGS!r}]
    for i, r in enumerate(repro.run(gm, batch=cfgs)):
        for k, v in sim_result(r).items():
            res[f"{{i}}/{{k}}"] = np.asarray(v)
        for k, v in r.telemetry.traces.items():
            res[f"{{i}}/telem/{{k}}"] = np.asarray(v)
    for j, kw in enumerate({SPECS!r}):
        s = TelemetrySpec(**kw)
        res[f"spec{{j}}/leaf_names"] = np.asarray(list(s.leaf_names()))
        res[f"spec{{j}}/horizon"] = np.asarray(s.horizon)
        res[f"spec{{j}}/memory_bytes"] = np.asarray(s.memory_bytes(16, 16))
    """
    return run_reference(tmp_path_factory, "telemetry_batch", body)


# ---------------------------------------------------------------------------
# The spec.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(buckets=0), dict(bucket_cycles=0),
                                dict(pe=False, links=False, eject=False,
                                     sched=False, stalls=False)],
                         ids=["buckets", "bucket_cycles", "no_groups"])
def test_spec_rejects(kw):
    with pytest.raises(ValueError):
        TelemetrySpec(**kw)


@pytest.mark.parametrize("bad", ["on", 1, dict(buckets=4)],
                         ids=["str", "int", "dict"])
def test_config_rejects_other_than_a_spec(bad):
    with pytest.raises(TypeError, match="TelemetrySpec"):
        OverlayConfig(telemetry=bad)


@pytest.mark.parametrize("j", range(len(SPECS)))
def test_spec_matches_reference(batch_reference, j):
    spec = TelemetrySpec(**SPECS[j])
    ref = {k.split("/", 1)[1]: v for k, v in batch_reference.items()
           if k.startswith(f"spec{j}/")}
    assert list(spec.leaf_names()) == ref["leaf_names"].tolist()
    assert spec.horizon == int(ref["horizon"])
    assert spec.memory_bytes(16, 16) == int(ref["memory_bytes"])
    per = TelemetrySpec.per_cycle(1234, pe=False)
    assert (per.buckets, per.bucket_cycles, per.pe) == (1234, 1, False)


def test_batch_needs_uniform_telemetry():
    gm = build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2)
    with pytest.raises(ValueError, match="uniform telemetry"):
        repro_torch.run(gm, batch=[OverlayConfig(telemetry=TelemetrySpec()),
                                   OverlayConfig()], device="cpu")


# ---------------------------------------------------------------------------
# Bucket clamp, one bucket a cycle, partial specs, budgets: every engine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["tensor", "select", "megakernel"])
@pytest.mark.parametrize("cell", [CLAMP, PER_CYCLE, *PARTIAL, BUDGET],
                         ids=lambda c: c[0].replace("/", "-"))
def test_cells_match_reference(reference, cell, engine):
    r = port_telemetry_run(cell, 7, engine)
    assert_telemetry_matches(r, reference, cell[0])


def test_bucket_clamp():
    """Cycles past the horizon land in the last bucket; every bucketed sum
    equals its stat counter."""
    r = port_telemetry_run(CLAMP, None, "tensor")
    t = r.telemetry.traces
    assert r.cycles > 32
    assert t["pe_busy"].shape == (4, 2, 2)
    assert int(t["pe_busy"][3].sum()) > int(t["pe_busy"][:3].sum())
    assert int(t["pe_busy"].sum()) == r.busy_cycles
    assert int(t["eject_grant"].sum()) == r.delivered
    assert int(t["defl_noc"].sum()) == r.noc_deflections
    assert int(t["defl_eject"].sum()) == r.eject_deflections
    one = port_telemetry_run(PER_CYCLE, None, "tensor").telemetry
    assert one.traces["pe_busy"].shape[0] == 1600
    assert one.used_buckets == one.cycles


# ---------------------------------------------------------------------------
# report() and the Perfetto export.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["tensor", "megakernel"])
def test_report_matches_reference(reference, engine):
    tel = port_telemetry_run(REPORTED, None, engine).telemetry
    assert tel.report() == json.loads(str(reference[f"{REPORTED[0]}/report"]))


def test_perfetto_matches_reference(reference, tmp_path):
    tel = port_telemetry_run(REPORTED, None, "select").telemetry
    path = tmp_path / "trace.json"
    got = tel.export_perfetto(str(path))
    want = json.loads(str(reference[f"{REPORTED[0]}/perfetto"]))
    assert got == want
    assert json.loads(path.read_text()) == want
    tracks = {(e["pid"], e["name"]) for e in got["traceEvents"]
              if e["ph"] == "C"}
    assert len(tracks) == track_count(tel.spec, 2, 2)
    assert tel.ascii_heatmap().startswith("pe_busy per PE")
    assert tel.wavefront()[-1] == int(tel.traces["pe_busy"].sum())


# ---------------------------------------------------------------------------
# The batched engines.
# ---------------------------------------------------------------------------

def _batch_memory():
    return build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2,
                              criticality_order=True)


@pytest.mark.parametrize("check_every", [7, None], ids=["7", "auto"])
@pytest.mark.parametrize("engine", ["tensor", "select", "megakernel"])
def test_batch_matches_solo_and_reference(batch_reference, engine,
                                          check_every):
    gm = _batch_memory()
    spec = TelemetrySpec(**BATCH_SPEC)
    cfgs = [OverlayConfig(check_every=check_every, engine=engine,
                          telemetry=spec, **kw) for kw in BATCH_CFGS]
    results = repro_torch.run(gm, batch=cfgs, device="cpu")
    for i, (cfg, r) in enumerate(zip(cfgs, results)):
        assert_telemetry_matches(r, batch_reference, str(i))
        solo = repro_torch.run(gm, cfg, device="cpu")
        assert solo.cycles == r.cycles
        assert_traces_equal(r.telemetry.traces, solo.telemetry.traces,
                            f"element {i}")


# ---------------------------------------------------------------------------
# The n15072 ``telemetry`` goldens of BENCH_overlay.json.
# ---------------------------------------------------------------------------

def _bench_row(sched):
    bench = json.loads((ROOT / "BENCH_overlay.json").read_text())
    return next(r for r in bench["telemetry"]["rows"]
                if r["name"] == f"telemetry_arrow_n15072_{sched}")


@pytest.mark.parametrize("sched", ["ooo", "inorder"])
def test_n15072_goldens(sched):
    want = _bench_row(sched)
    g = wl.arrow_lu_graph(4, 10, 8, seed=3)
    gm = build_graph_memory(g, 16, 16, criticality_order=sched == "ooo")
    r = repro_torch.run(gm, OverlayConfig(scheduler=sched,
                                          telemetry=TelemetrySpec()),
                        device="cpu")
    rep = r.telemetry.report()
    got = {
        f"cycles_{sched}": r.cycles,
        "ctr_busy_total": r.busy_cycles,
        "ctr_delivered": r.delivered,
        "ctr_noc_deflections": r.noc_deflections,
        "ctr_eject_deflections": r.eject_deflections,
        "ctr_link_busy_max": rep["links"]["busy_max"],
        "ctr_stall_no_ready": rep["stalls"]["no_ready"],
        "ctr_stall_inject_blocked": rep["stalls"]["inject_blocked"],
        "ctr_stall_select_wait": rep["stalls"]["select_wait"],
        "ctr_picks": rep["sched"]["picks"],
        "link_util_p50": rep["links"]["util_p50"],
        "link_util_p95": rep["links"]["util_p95"],
        "link_util_max": rep["links"]["util_max"],
        "pick_pos_mean": rep["sched"]["pick_pos_mean"],
        "ready_depth_mean": rep["sched"]["ready_depth_mean"],
    }
    assert got == {k: want[k] for k in got}


# ---------------------------------------------------------------------------
# The CLI and the untraced state.
# ---------------------------------------------------------------------------

def test_cli_smoke(tmp_path, capsys):
    from repro_torch.telemetry.__main__ import main

    assert main(["--smoke", "--device", "cpu", "--out", str(tmp_path)]) == 0
    assert "TELEMETRY_SMOKE_OK" in capsys.readouterr().out
    assert sorted(p.name for p in Path(tmp_path).iterdir()) == [
        "smoke_inorder.perfetto.json", "smoke_ooo.perfetto.json"]


def test_untraced_state_has_no_trace_leaves():
    from repro_torch.core.overlay import device_graph, init_state

    gm = build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2)
    g = device_graph(gm, "cpu")
    assert "telem" not in init_state(g, OverlayConfig())
    traced = init_state(g, OverlayConfig(telemetry=TelemetrySpec(
        buckets=5, links=False)))
    assert sorted(traced["telem"]) == sorted(
        TelemetrySpec(links=False).leaf_names())
    assert traced["telem"]["pe_busy"].shape == (5, 2, 2)
    assert repro_torch.run(gm, OverlayConfig(), device="cpu").telemetry is None


@pytest.mark.parametrize("which", ["untraced_state", "traced_state",
                                   "other_spec"])
def test_megakernel_leaf_check(which):
    """The megakernel's leaf check takes the trace leaves of the spec in
    use and nothing else."""
    from repro_torch.core.overlay import device_graph, init_state
    from repro_torch.kernels import megakernel as mk

    gm = build_graph_memory(wl.layered_dag(4, 6, seed=3), 2, 2)
    g = device_graph(gm, "cpu")
    spec = TelemetrySpec(buckets=4)
    plain, traced = (OverlayConfig(engine="megakernel"),
                     OverlayConfig(engine="megakernel", telemetry=spec))
    other = OverlayConfig(engine="megakernel",
                          telemetry=TelemetrySpec(buckets=5))
    cfg, state = {"untraced_state": (traced, init_state(g, plain)),
                  "traced_state": (plain, init_state(g, traced)),
                  "other_spec": (traced, init_state(g, other))}[which]
    with pytest.raises(ValueError, match="telem"):
        mk.make_mega_chunk_fn(g, cfg, 4)(state)
    out = mk.make_mega_chunk_fn(g, traced, 4)(init_state(g, traced))
    assert out["telem"]["pe_occ"].shape == (4, 2, 2)
    assert int(out["telem"]["eject_grant"].sum()) == int(out["delivered"])
