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

import contextlib
import dataclasses
import datetime
import functools
import os
import subprocess
import sys
import textwrap
import time
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
                  legacy_prng: bool = False, env: dict | None = None) -> dict:
    """Run ``body`` (which fills the dict ``res``) under the reference in a
    subprocess and return ``res`` as numpy arrays. ``legacy_prng`` runs it
    on the non-partitionable Threefry layout (:data:`LEGACY_PRNG`); ``env``
    adds environment variables (e.g. ``XLA_FLAGS`` for fake host devices,
    read when jax is imported)."""
    out = tmp_path_factory.mktemp(name) / "reference.npz"
    script = (_PRELUDE + (LEGACY_PRNG if legacy_prng else "")
              + textwrap.dedent(body) + "\nnp.savez(sys.argv[1], **res)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               **(env or {}))
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


# ---------------------------------------------------------------------------
# The sharded engines (``run(..., mesh=)``) on gloo ranks.
# ---------------------------------------------------------------------------

#: Seconds a process group waits on a collective before it fails the rank.
GROUP_TIMEOUT_S = 120


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A 1x1 CPU ``DeviceMesh`` (dims ``("data", "model")``) over a gloo
    group of this process alone, joined through a ``FileStore`` under
    ``tmp_path``; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()

_RANK_PRELUDE = f"""\
import datetime
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group(
    "gloo", store=dist.FileStore(sys.argv[3], world), rank=rank,
    world_size=world,
    timeout=datetime.timedelta(seconds={GROUP_TIMEOUT_S}))


def mesh_of(shape):
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def put(key, r):
    for k in {RESULT_KEYS!r}:
        res[f"{{key}}/{{k}}"] = np.asarray(getattr(r, k))
    if r.telemetry is not None:
        for k, v in r.telemetry.traces.items():
            res[f"{{key}}/telem/{{k}}"] = v


res = {{}}
"""


def run_ranks(tmp_path_factory, name: str, world: int, body: str, *,
              timeout: float = 300) -> list[dict]:
    """Run ``body`` on ``world`` gloo ranks on the CPU, one subprocess a
    rank. The ranks meet through a ``FileStore`` in a fresh temporary
    directory (no TCP port, so concurrent test workers cannot collide), and
    every collective fails its rank after :data:`GROUP_TIMEOUT_S` seconds
    instead of hanging. ``body`` sees ``rank``, ``world``, ``mesh_of(shape)``
    (a CPU ``DeviceMesh`` with dims ``("data", "model")``) and
    ``put(key, result)``, and fills the dict ``res``. Returns each rank's
    ``res`` as numpy arrays, by rank; any rank's failure raises."""
    d = tmp_path_factory.mktemp(name)
    script = (_RANK_PRELUDE + textwrap.dedent(body)
              + "\ndist.destroy_process_group()\nnp.savez(sys.argv[4], **res)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [open(d / f"rank{r}.log", "w+") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(world),
                 str(d / "store"), str(d / f"rank{r}.npz")],
                env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        failed = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                log.seek(0)
                failed.append(f"rank {r} (rc {p.returncode}):\n"
                              f"{log.read()[-3000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r in range(world):
        with np.load(d / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def assert_same_result(got, want, label="") -> None:
    """Two port results: every counter, every value as a bit pattern, and
    every trace leaf equal."""
    for k in RESULT_KEYS:
        a, b = getattr(got, k), getattr(want, k)
        if k == "values":
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"{label} values")
        else:
            assert a == b, (label, k, a, b)
    assert (got.telemetry is None) == (want.telemetry is None), label
    if want.telemetry is not None:
        assert_traces_equal(got.telemetry.traces, want.telemetry.traces, label)


def assert_rank_matches(res: dict, key: str, want) -> None:
    """One rank's saved result ``key`` (``put`` in :func:`run_ranks`)
    equals the port result ``want``, bit for bit, traces included."""
    for k in RESULT_KEYS:
        got = res[f"{key}/{k}"]
        if k == "values":
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.values.view(np.int32),
                                          err_msg=f"{key} values")
        else:
            assert got.item() == getattr(want, k), (key, k, got, want)
    traces = {k[len(key) + 7:]: v for k, v in res.items()
              if k.startswith(key + "/telem/")}
    if want.telemetry is None:
        assert not traces, key
    else:
        assert_traces_equal(traces, want.telemetry.traces, key)


#: The runs of the mesh tests on every mesh: key -> config keywords (a list
#: of them for a batch; ``telemetry`` as TelemetrySpec keywords). The graph:
#: ``arrow_lu_graph(2, 5, 3, seed=4)`` on 4x4 (criticality layout), 238-277
#: cycles a policy; the batches hold every policy and ``scan`` again at a
#: budget of 60 (frozen mid-run).
_POLICIES = ("ooo", "inorder", "lru_flat", "scan")
_SPEC = dict(buckets=16, bucket_cycles=8)
MESH_RUNS = {
    **{f"{p}/{e}": dict(scheduler=p, engine=e)
       for p in _POLICIES for e in ("tensor", "select", "megakernel")},
    **{f"ooo/tensor/K{k}": dict(check_every=k, engine="tensor")
       for k in (1, 7)},
    **{f"batch/{e}": [*(dict(scheduler=p, engine=e) for p in _POLICIES),
                      dict(scheduler="scan", max_cycles=60, engine=e)]
       for e in ("tensor", "megakernel")},
    "traced/select": dict(engine="select", telemetry=_SPEC),
    "traced_batch/megakernel": [
        dict(scheduler=s, engine="megakernel", telemetry=_SPEC)
        for s in ("ooo", "inorder")],
}

_MESH_BODY = """
import repro_torch
from repro_torch import place
from repro_torch.core import distributed
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.core.partition import build_graph_memory
from repro_torch.telemetry import TelemetrySpec


def config(kw):
    kw = dict(kw)
    if "telemetry" in kw:
        kw["telemetry"] = TelemetrySpec(**kw["telemetry"])
    return OverlayConfig(**kw)


g = wl.arrow_lu_graph(2, 5, 3, seed=4)
gm = build_graph_memory(g, 4, 4, criticality_order=True)
for shape in SHAPES:
    mesh = mesh_of(shape)
    tag = "x".join(map(str, shape))
    for key, kw in MESH_RUNS.items():
        if isinstance(kw, list):
            rs = repro_torch.run(gm, mesh=mesh, device="cpu",
                                 batch=[config(c) for c in kw])
            for i, r in enumerate(rs):
                put(f"{tag}/{key}/{i}", r)
        else:
            put(f"{tag}/{key}", repro_torch.run(gm, config(kw), mesh=mesh,
                                                device="cpu"))
    res[f"{tag}/route"] = np.asarray(distributed.route(mesh, "cpu"))
"""




def mesh_config(kw):
    """An OverlayConfig from :data:`MESH_RUNS` keywords."""
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.telemetry import TelemetrySpec

    kw = dict(kw)
    if "telemetry" in kw:
        kw["telemetry"] = TelemetrySpec(**kw["telemetry"])
    return OverlayConfig(**kw)


def mesh_runs(tmp_path_factory, name: str, world: int, shapes, extra: str = ""):
    """Every rank's results of :data:`MESH_RUNS` on each mesh of ``shapes``
    (``put`` under ``"<shape>/<key>"``, batches ``"<shape>/<key>/<i>"``,
    the route under ``"<shape>/route"``), then ``extra`` (a body that may
    use ``g``, ``gm`` and ``config``), on ``world`` gloo ranks."""
    head = f"SHAPES = {tuple(shapes)!r}\nMESH_RUNS = {MESH_RUNS!r}\n"
    return run_ranks(tmp_path_factory, name, world,
                     head + _MESH_BODY + textwrap.dedent(extra))


@functools.lru_cache(maxsize=None)
def mesh_single_run(key: str):
    """The port's single-device run of ``MESH_RUNS[key]``."""
    import repro_torch
    from repro_torch.core import workloads as wl
    from repro_torch.core.partition import build_graph_memory

    gm = build_graph_memory(wl.arrow_lu_graph(2, 5, 3, seed=4), 4, 4,
                            criticality_order=True)
    kw = MESH_RUNS[key]
    if isinstance(kw, list):
        return repro_torch.run(gm, batch=[mesh_config(c) for c in kw],
                               device="cpu")
    return repro_torch.run(gm, mesh_config(kw), device="cpu")


def assert_mesh_run(results: list, tag: str, key: str) -> None:
    """Every rank's run ``key`` on mesh ``tag`` equals the single-device
    run, and went over gloo with host tensors."""
    want = mesh_single_run(key)
    for res in results:
        assert str(res[f"{tag}/route"]) == "gloo, host tensors"
        if isinstance(want, list):
            for i, w in enumerate(want):
                assert_rank_matches(res, f"{tag}/{key}/{i}", w)
        else:
            assert_rank_matches(res, f"{tag}/{key}", want)
