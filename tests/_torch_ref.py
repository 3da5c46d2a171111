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


def run_reference(tmp_path_factory, name: str, body: str) -> dict:
    """Run ``body`` (which fills the dict ``res``) under the reference in a
    subprocess and return ``res`` as numpy arrays."""
    out = tmp_path_factory.mktemp(name) / "reference.npz"
    script = _PRELUDE + textwrap.dedent(body) + "\nnp.savez(sys.argv[1], **res)\n"
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
