"""CPU tests of the benchmark's manifest (``BENCHMARK.json``) and of the
files it names: the contract's character and size rules, every cell's
files, and that nothing the harness loads is JAX or the JAX package."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.fullmatch(p) and ".." not in p.split("/")
        assert not p.startswith("/") and (ROOT / p).is_dir()
    for word in MANIFEST["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    seconds = MANIFEST["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_follow_the_rules(section):
    entries = MANIFEST[section]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24,
                                 "end_to_end": 16, "per_layer": 128}[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if section == "configs":
            assert len(e["reduced"]) <= 16
            assert all(NAME.fullmatch(k) for k in e["reduced"])
        if section == "workloads":
            assert e["chips"] in (1, 4)
            assert NAME.fullmatch(e["config"]) and NAME.fullmatch(e["traffic"])
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            floor = 0.01
            assert floor <= e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            # A kernel's share of its roofline is named <kernel>_roofline.
            if "roofline" in e["name"]:
                assert e["name"].endswith("_roofline") and e["unit"] == "%"


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        where = set(m.get("workloads", cells))
        assert where <= cells and where <= e2e[m["moves"]], m["name"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    # One spelling a layer.
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        assert any(cell in w for n, w in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_resolve(cell):
    from bench_port import traffic

    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    entry = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    path = ROOT / entry["file"]
    assert any(entry["file"].startswith(p + "/") for p in MANIFEST["paths"])
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert (HERE / f"{config['reference']}.py").is_file()
    from bench_port import overlay_ref

    kinds = traffic.kinds(traffic.load(HERE / "traffic" / f"{w['traffic']}.json"))
    assert kinds and all(k.scheduler in overlay_ref.POLICIES for k in kinds)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            reader = HERE / "metrics" / f"{m['name']}.py"
            assert "def read(ctx)" in reader.read_text(), m["name"]


def test_config_files_are_unique():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)


def test_forbidden_names_compare_whole(monkeypatch):
    from bench_port import harness

    for name in ("repro_torch", "repro_torch.core", "reproX", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"repro_torch", "reprox", "jaxtyping"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core.graph", sys)
    assert "repro" in harness.forbidden_modules()


def test_harness_loads_no_jax():
    """A fresh process imports the harness, every metric reader and the port
    and drives a tiny cell on the CPU: no top-level ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` module is loaded."""
    code = (
        "import sys, io, json, time\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from bench_port import harness, control, run\n"
        "from bench_port import test_bench_port_faults as t\n"
        f"m = json.loads(open({str(ROOT / 'BENCHMARK.json')!r}).read())\n"
        "for e in m['end_to_end'] + m['per_layer']:\n"
        "    harness.load_metric(e['name'])\n"
        "import tempfile, pathlib\n"
        "d = pathlib.Path(tempfile.mkdtemp())\n"
        "man = t.tiny_bench(d)\n"
        "out = io.StringIO()\n"
        "harness.run(man, 'fig1-n470772.mk-solo', 7, 0.01, False, base=d,\n"
        "            t_start=time.perf_counter(), device='cpu',\n"
        "            traffic_dir=d / 'traffic', out=out, err=io.StringIO())\n"
        "assert json.loads(out.getvalue().splitlines()[-1])['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []

