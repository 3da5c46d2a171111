"""The port's three entry points on the CPU: ``python -m
repro_torch.core.workloads`` (``warm_cache`` into a temporary
``$REPRO_GRAPH_CACHE``, the reference's cache files loaded both ways),
``python -m repro_torch.kernels`` (the smoke's matrix part with
``device="cpu"``, against the reference's per-cycle engine) and ``python -m
repro_torch.service`` (the stream demo, line for line the reference's).
The smokes themselves run on the card (``chip_smoke.py``'s service phase).
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_ref import ROOT, run_reference

from repro_torch.core import workloads as wl
from repro_torch.kernels import __main__ as kernels_cli
from repro_torch.service import __main__ as service_cli

#: A small arrow-LU name of the warm_cache family, and its arguments.
ARROW = ("arrow_b2_s6_w4_seed1", (2, 6, 4, 1))
GRAPH_FIELDS = ("opcode", "fanout_ptr", "fanout_dst", "fanout_slot",
                "initial_values")


@pytest.fixture(scope="module")
def ref_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("ref_graph_cache")


@pytest.fixture(scope="module")
def reference(tmp_path_factory, ref_cache):
    body = f"""
    import contextlib, io, os
    os.environ["REPRO_GRAPH_CACHE"] = {str(ref_cache)!r}
    from repro import run
    from repro.core import schedulers
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory

    built = wl.warm_cache([{ARROW[0]!r}])
    res["warm/nodes"] = np.asarray(built[{ARROW[0]!r}])
    res["mk_graphs"] = np.asarray(wl.MEGAKERNEL_BENCH_GRAPHS)

    g = wl.layered_dag(4, 6, seed=3)
    for sched in sorted(schedulers.REGISTRY):
        gm = build_graph_memory(
            g, 2, 2,
            criticality_order=schedulers.get(sched).wants_criticality_order)
        res.update(flatten(sim_result(run(gm, OverlayConfig(
            scheduler=sched, check_every=1))), f"matrix/{{sched}}"))

    from repro.service.__main__ import demo
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        demo()
    res["demo"] = np.str_(out.getvalue())
    """
    return run_reference(tmp_path_factory, "service_cli", body,
                         legacy_prng=True)


def test_warm_cache_loads_the_reference_file(reference, ref_cache,
                                             monkeypatch):
    name, (b, s, w, seed) = ARROW
    path = ref_cache / f"{name}.npz"
    assert path.exists()
    stamp = path.stat().st_mtime_ns
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(ref_cache))
    assert wl.warm_cache([name]) == {name: int(reference["warm/nodes"])}
    assert path.stat().st_mtime_ns == stamp     # loaded, not rebuilt
    g = wl.load_graph(str(path))
    want = wl.arrow_lu_graph(b, s, w, seed=seed)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(want, f))


def test_warm_cache_builds_megakernel_bench(reference, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path))
    assert wl.MEGAKERNEL_BENCH_GRAPHS == tuple(reference["mk_graphs"].tolist())
    built = wl.warm_cache(["megakernel_bench"])
    assert built == {"arrow_b4_s10_w8_seed3": 15072,
                     "arrow_b8_s10_w8_seed3": 29772}
    for name in built:
        assert (tmp_path / f"{name}.npz").exists()


@pytest.mark.parametrize("name", ["bogus", "arrow_b2_s6", "arrow_x1"])
def test_warm_cache_rejects_unknown_names(name, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="don't know how to build"):
        wl.warm_cache([name])


def test_workloads_cli(tmp_path):
    env = dict(os.environ, REPRO_GRAPH_CACHE=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.workloads", ARROW[0]],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == (f"{ARROW[0]}: 1380 nodes (cache: "
                                   f"{tmp_path})")
    assert (tmp_path / f"{ARROW[0]}.npz").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.workloads", "bogus"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "ValueError" in proc.stderr


def test_kernels_smoke_matrix_on_cpu(reference):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = kernels_cli.matrix(device="cpu")
    assert sorted(results) == ["inorder", "lru_flat", "ooo", "scan"]
    for sched, r in results.items():
        for k in ("cycles", "done", "delivered", "deflections",
                  "busy_cycles"):
            assert getattr(r, k) == reference[f"matrix/{sched}/{k}"].item(), (
                sched, k)
        np.testing.assert_array_equal(r.values,
                                      reference[f"matrix/{sched}/values"])
    assert out.getvalue().splitlines() == [
        f"megakernel_smoke_{s},0.0,{results[s].cycles}"
        for s in sorted(results)]


def test_kernels_cli_usage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert kernels_cli.main([]) == 2
    assert "--smoke" in out.getvalue()


def test_service_demo_equal_reference(reference):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert service_cli.main(["--device", "cpu"]) == 0
    assert out.getvalue() == str(reference["demo"])
    assert out.getvalue().count("hit ") == 12
