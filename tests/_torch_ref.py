"""Shared harness of the port's parity tests (``tests/test_torch_*.py``).

Reference results come from the JAX package, computed in ONE subprocess per
test module. The reference imports ``enable_x64`` from ``jax.experimental``,
which the installed jax no longer has; the subprocess aliases it to
``jax.enable_x64`` before importing ``repro``. Doing that in the pytest
process instead would patch ``jax.experimental`` for every other test file
that shares the worker, and change which of the reference's own tests pass.

Inputs are made from numpy seeds and handed to both sides as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = """\
import sys
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
import numpy as np


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def sim_result(r):
    return dict(cycles=r.cycles, done=r.done, delivered=r.delivered,
                noc_deflections=r.noc_deflections,
                eject_deflections=r.eject_deflections,
                deflections=r.deflections, busy_cycles=r.busy_cycles,
                values=r.values)


res = {}
"""

RESULT_KEYS = ("cycles", "done", "delivered", "noc_deflections",
               "eject_deflections", "deflections", "busy_cycles", "values")

#: The small matrix graph and its grid (the reference's chunked-engine tests).
MATRIX_GRAPH = (3, 6, 4, 5)
MATRIX_GRID = (2, 2)

#: Eject configurations of the matrix: (eject_capacity, eject_policy).
EJECTS = {"n_first_cap1": (1, "n_first"), "priority_cap1": (1, "priority"),
          "cap2": (2, "n_first")}

#: Reference cycle/deflection counts on the matrix graph (n_first, cap 1);
#: every policy fires 1777 nodes and delivers 3554 packets.
GOLDENS = {"ooo": (1402, 2358), "inorder": (1507, 2508),
           "lru_flat": (1486, 2328), "scan": (8664, 161)}


#: Selects the non-partitionable Threefry layout in the reference's process:
#: the layout ``BENCH_overlay.json``'s placement goldens were recorded on,
#: and the one :mod:`repro_torch.core.prng` follows.
LEGACY_PRNG = 'jax.config.update("jax_threefry_partitionable", False)\n'


def run_reference(tmp_path_factory, name: str, body: str, *,
                  legacy_prng: bool = False) -> dict:
    """Run ``body`` (which fills the dict ``res``) under the reference in a
    subprocess and return ``res`` as numpy arrays. ``legacy_prng`` runs it
    on the non-partitionable Threefry layout (:data:`LEGACY_PRNG`)."""
    out = tmp_path_factory.mktemp(name) / "reference.npz"
    script = (_PRELUDE + (LEGACY_PRNG if legacy_prng else "")
              + textwrap.dedent(body) + "\nnp.savez(sys.argv[1], **res)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def unflatten(flat: dict, prefix: str) -> dict:
    """Inverse of the subprocess's ``flatten`` for keys under ``prefix``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def assert_tree_equal(got: dict, want: dict, path: str = "") -> None:
    """Nested dicts of numpy arrays: same keys, dtypes and values."""
    assert got.keys() == want.keys(), path
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
            continue
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, f"{path}/{k}"
        np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


def matrix_reference(tmp_path_factory, policy: str, cells,
                     engine: str = "jnp") -> dict:
    """Reference results of ``policy`` on the matrix graph for each
    ``(check_every, eject)`` in ``cells`` under the reference's ``engine``,
    keyed ``"<K>/<eject>/<field>"``."""
    crit = policy == "ooo"
    body = f"""
    import repro
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory

    b, s, w, seed = {MATRIX_GRAPH!r}
    g = wl.arrow_lu_graph(b, s, w, seed=seed)
    gm = build_graph_memory(g, *{MATRIX_GRID!r},
                            criticality_order={crit!r})
    ejects = {EJECTS!r}
    for K, eject in {sorted(set(cells))!r}:
        cap, pol = ejects[eject]
        r = repro.run(gm, OverlayConfig(scheduler={policy!r}, check_every=K,
                                        eject_capacity=cap, eject_policy=pol,
                                        engine={engine!r}))
        for k, v in sim_result(r).items():
            res[f"{{K}}/{{eject}}/{{k}}"] = np.asarray(v)
    """
    return run_reference(tmp_path_factory, f"matrix_{policy}_{engine}", body)


@functools.lru_cache(maxsize=None)
def _matrix_memory(policy: str):
    from repro_torch.core import workloads as wl
    from repro_torch.core.partition import build_graph_memory

    b, s, w, seed = MATRIX_GRAPH
    g = wl.arrow_lu_graph(b, s, w, seed=seed)
    return build_graph_memory(g, *MATRIX_GRID,
                              criticality_order=policy == "ooo")


@functools.lru_cache(maxsize=None)
def port_matrix_run(policy: str, check_every: int, eject: str, engine: str):
    """The port's result for one matrix cell, on the CPU (cached per module
    process, so the golden checks reuse the parity runs)."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig

    cap, pol = EJECTS[eject]
    cfg = OverlayConfig(scheduler=policy, check_every=check_every,
                        eject_capacity=cap, eject_policy=pol, engine=engine)
    return repro_torch.run(_matrix_memory(policy), cfg, device="cpu")


def assert_matches(result, ref: dict, prefix: str) -> None:
    """Every counter and every node value equal, bit for bit."""
    for k in RESULT_KEYS:
        want = ref[f"{prefix}/{k}"]
        got = getattr(result, k)
        if k == "values":
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want.item(), (prefix, k, got, want)


# ---------------------------------------------------------------------------
# The batched sweep engine (``run(gm, batch=cfgs)``).
# ---------------------------------------------------------------------------

#: Policies in the order the reference's batch tests list them.
BATCH_POLICIES = ("inorder", "lru_flat", "ooo", "scan")

#: The reference's own batch cases: name -> (graph, grid, configs as
#: OverlayConfig keyword dicts). Every policy on one (criticality) layout.
#:  * "chunked": ``tests/test_chunked.py:71-89``, with ``scan`` at a budget
#:    of 100 (it freezes mid-run) and ``ooo`` at select latency 4 (it
#:    finishes early and keeps re-entering chunks);
#:  * "budget": ``tests/test_chunked.py:91-105``, a budget on a chunk
#:    boundary (98 = 14 x 7);
#:  * "layered": ``tests/test_megakernel.py:62-75``.
BATCH_CASES = {
    "chunked": ("arrow", (4, 4), [
        *(dict(scheduler=p, max_cycles=500_000) for p in BATCH_POLICIES),
        dict(scheduler="scan", max_cycles=100),
        dict(scheduler="ooo", select_latency=4, max_cycles=500_000)]),
    "budget": ("arrow", (4, 4), [dict(scheduler="scan", max_cycles=98),
                                 dict(scheduler="ooo", max_cycles=500_000)]),
    "layered": ("layered", (2, 2), [
        *(dict(scheduler=p, max_cycles=100_000) for p in BATCH_POLICIES),
        dict(scheduler="scan", max_cycles=20)]),
}

#: The reference engine each port engine is held against.
REF_ENGINE = {"tensor": "jnp", "select": "select", "megakernel": "megakernel"}

_GRAPHS_SRC = f"""
from repro.core import workloads as wl
b, s, w, seed = {MATRIX_GRAPH!r}
graphs = dict(arrow=lambda: wl.arrow_lu_graph(b, s, w, seed=seed),
              layered=lambda: wl.layered_dag(4, 6, seed=3))
"""


def batch_reference(tmp_path_factory, name: str, runs) -> dict:
    """The reference's ``repro.run(gm, batch=cfgs)`` for each
    ``(case, check_every, port engine)`` in ``runs``, keyed
    ``"<case>/<K>/<engine>/<b>/<field>"``."""
    body = _GRAPHS_SRC + f"""
import repro
from repro.core.overlay import OverlayConfig
from repro.core.partition import build_graph_memory

cases = {BATCH_CASES!r}
engines = {REF_ENGINE!r}
for case, K, engine in {sorted(set(runs))!r}:
    graph, (nx, ny), kws = cases[case]
    gm = build_graph_memory(graphs[graph](), nx, ny, criticality_order=True)
    cfgs = [OverlayConfig(check_every=K, engine=engines[engine], **kw)
            for kw in kws]
    for i, r in enumerate(repro.run(gm, batch=cfgs)):
        for k, v in sim_result(r).items():
            res[f"{{case}}/{{K}}/{{engine}}/{{i}}/{{k}}"] = np.asarray(v)
"""
    return run_reference(tmp_path_factory, name, body)


@functools.lru_cache(maxsize=None)
def batch_memory(graph: str, nx: int, ny: int):
    from repro_torch.core import workloads as wl
    from repro_torch.core.partition import build_graph_memory

    b, s, w, seed = MATRIX_GRAPH
    g = (wl.arrow_lu_graph(b, s, w, seed=seed) if graph == "arrow"
         else wl.layered_dag(4, 6, seed=3))
    return build_graph_memory(g, nx, ny, criticality_order=True)


def batch_configs(case: str, check_every: int, engine: str):
    from repro_torch.core.overlay import OverlayConfig

    _, _, kws = BATCH_CASES[case]
    return [OverlayConfig(check_every=check_every, engine=engine, **kw)
            for kw in kws]


@functools.lru_cache(maxsize=None)
def port_batch_run(case: str, check_every: int, engine: str):
    """The port's ``run(gm, batch=cfgs, device="cpu")`` of one case."""
    import repro_torch

    graph, grid, _ = BATCH_CASES[case]
    return repro_torch.run(batch_memory(graph, *grid),
                           batch=batch_configs(case, check_every, engine),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def port_solo_run(graph: str, grid: tuple, cfg):
    """The port's solo run of one config (cached per module process)."""
    import repro_torch

    return repro_torch.run(batch_memory(graph, *grid), cfg, device="cpu")


def assert_batch_matches(reference: dict, case: str, check_every: int,
                         engine: str) -> None:
    """Every element of the port's batch equals the reference's batch bit
    for bit, and the port's solo run of its config."""
    graph, grid, _ = BATCH_CASES[case]
    results = port_batch_run(case, check_every, engine)
    cfgs = batch_configs(case, check_every, engine)
    assert len(results) == len(cfgs)
    for i, (cfg, r) in enumerate(zip(cfgs, results)):
        assert_matches(r, reference, f"{case}/{check_every}/{engine}/{i}")
        solo = port_solo_run(graph, grid,
                             dataclasses.replace(cfg, check_every=None))
        for k in RESULT_KEYS:
            got, want = getattr(r, k), getattr(solo, k)
            if k == "values":
                np.testing.assert_array_equal(got.view(np.int32),
                                              want.view(np.int32))
            else:
                assert got == want, (case, i, k, got, want)


# ---------------------------------------------------------------------------
# Telemetry (``OverlayConfig(telemetry=TelemetrySpec(...))``).
# ---------------------------------------------------------------------------

#: The trace spec of the matrix cells: 16 buckets of 8 cycles (the matrix
#: runs ~1,400-8,700 cycles, so the last bucket also takes the clamped ones).
TELEMETRY_SPEC = dict(buckets=16, bucket_cycles=8)


def telemetry_cell(policy: str, eject: str, spec=None,
                   budget: int = 1_000_000) -> tuple:
    """One traced matrix cell: ``(key, policy, eject, spec as a tuple of
    keyword pairs, max_cycles)``; ``spec`` defaults to
    :data:`TELEMETRY_SPEC`."""
    pairs = tuple(sorted((spec or TELEMETRY_SPEC).items()))
    tag = "_".join(f"{k}{int(v)}" for k, v in pairs)
    return (f"{policy}/{eject}/{tag}/{budget}", policy, eject, pairs, budget)


def telemetry_reference(tmp_path_factory, name: str, cells) -> dict:
    """The reference's traced runs on the matrix graph (2x2), on its
    ``jnp`` engine at check_every 1, for each :func:`telemetry_cell` in
    ``cells``: the result fields, each trace leaf (``telem/<leaf>``), the
    report as JSON (``report``) and the Perfetto export as JSON
    (``perfetto``), under the cell's key."""
    body = f"""
    import json
    import repro
    from repro.core import workloads as wl
    from repro.core.overlay import OverlayConfig
    from repro.core.partition import build_graph_memory
    from repro.telemetry import TelemetrySpec

    b, s, w, seed = {MATRIX_GRAPH!r}
    g = wl.arrow_lu_graph(b, s, w, seed=seed)
    ejects = {EJECTS!r}
    for key, policy, eject, spec, budget in {sorted(set(cells))!r}:
        gm = build_graph_memory(g, *{MATRIX_GRID!r},
                                criticality_order=policy == "ooo")
        cap, pol = ejects[eject]
        r = repro.run(gm, OverlayConfig(
            scheduler=policy, check_every=1, eject_capacity=cap,
            eject_policy=pol, max_cycles=budget, engine="jnp",
            telemetry=TelemetrySpec(**dict(spec))))
        for k, v in sim_result(r).items():
            res[f"{{key}}/{{k}}"] = np.asarray(v)
        for k, v in r.telemetry.traces.items():
            res[f"{{key}}/telem/{{k}}"] = np.asarray(v)
        res[f"{{key}}/report"] = np.asarray(json.dumps(r.telemetry.report()))
        res[f"{{key}}/perfetto"] = np.asarray(
            json.dumps(r.telemetry.export_perfetto()))
    """
    return run_reference(tmp_path_factory, name, body)


@functools.lru_cache(maxsize=None)
def port_telemetry_run(cell: tuple, check_every, engine: str):
    """The port's traced run of one :func:`telemetry_cell` at
    ``check_every`` under ``engine``, on the CPU (cached per module
    process)."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.telemetry import TelemetrySpec

    _, policy, eject, spec, budget = cell
    cap, pol = EJECTS[eject]
    cfg = OverlayConfig(scheduler=policy, check_every=check_every,
                        eject_capacity=cap, eject_policy=pol, engine=engine,
                        max_cycles=budget, telemetry=TelemetrySpec(**dict(spec)))
    return repro_torch.run(_matrix_memory(policy), cfg, device="cpu")


def assert_traces_equal(got: dict, want: dict, label="") -> None:
    """Two traces dicts: the same leaves, each int32 and equal bit for bit."""
    assert sorted(got) == sorted(want), label
    for k in want:
        assert got[k].dtype == np.int32, (label, k, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


def assert_telemetry_matches(result, ref: dict, key: str) -> None:
    """A traced run equals the reference's: every counter and value, and
    every trace leaf."""
    assert_matches(result, ref, key)
    want = {k[len(key) + 7:]: v for k, v in ref.items()
            if k.startswith(key + "/telem/")}
    assert_traces_equal(result.telemetry.traces, want, key)
