"""Write ``dryrun_reference.json``: the reference package's dry-run records
that the port's dry-run (``repro_torch.launch.dryrun``) is held to on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_dryrun_reference.py

Two parts, both on the reference's production meshes over 512 fake host
devices (``single`` 16 x 16, ``multi`` 2 x 16 x 16):

  * ``cells``: ``repro.launch.dryrun.run_cell`` with each arch's smoke
    config as ``cfg_override``, its attention, loss and SSD chunks set to
    the full configs' (``SMOKE_CHUNKS``, kept in the file as
    ``smoke_chunks``: the smoke configs' 32-token chunks would make the
    port's eager train step at 4,096 tokens ~16,000 blocks a layer, and
    their 16-token SSD chunks its eager scan at 32,768 tokens 2,048 steps a
    layer), qwen2-0.5b at every shape, every other arch at
    ``prefill_32k``, ``decode_32k`` and ``long_500k`` (a smoke train cell
    takes ~2.5 minutes to compile on a CPU), both meshes. Each record keeps
    ``status``, ``reason``, ``chips``, ``tokens`` (``_tokens``), the
    roofline's ``model_flops_total``, ``memory`` (``memory_analysis()``),
    the HLO walk's ``flops``, ``bytes``, ``collective_traffic``,
    ``collective_count`` and ``unknown_trips`` (its loops of unknown trip
    count, each counted once), ``pruned_argument_bytes`` (the bytes of the
    inputs ``jax.jit`` dropped as unread, ``keep_unused=False``, which
    ``memory_analysis()`` leaves out: from the lowered module's kept
    arguments), and the error of a ``FAIL``.
  * ``full``: every arch's full config at every shape on both meshes,
    without compiling: ``status`` and ``reason`` (``shape_applicable``),
    ``tokens``, ``model_flops_total`` and ``argument_bytes``, the bytes of
    one device's blocks of every input of the cell's step (``build_cell``'s
    abstract arguments under its shardings: state and batch; parameters,
    batch and cache; parameters, tokens, cache and ``cache_len``), summed
    from each leaf's ``NamedSharding.shard_shape``. Also ``param_count``
    and ``active_param_count`` of every arch.

The reference imports ``enable_x64`` from ``jax.experimental``, which newer
jax lacks, so this script aliases it to ``jax.enable_x64`` first. Takes
~4 minutes on the CPU.
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.experimental  # noqa: E402

jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.optim import AdamW, wsd_schedule  # noqa: E402
from repro.train import steps as tsteps  # noqa: E402

OUT = Path(__file__).with_name("dryrun_reference.json")
MESHES = ("single", "multi")
#: The smoke configs' chunks in the compiled cells (the full configs').
SMOKE_CHUNKS = {"attn_chunk": 1024, "loss_chunk": 2048, "ssm_chunk": 256}
#: The smoke cells compiled: arch -> shapes.
SMOKE_CELLS = {arch: (tuple(SHAPES) if arch == "qwen2-0.5b" else
                      ("prefill_32k", "decode_32k", "long_500k"))
               for arch in ARCHS}


def _bytes(leaves, specs, mesh) -> list:
    """One device's bytes of each leaf of ``leaves`` under ``specs``, in
    ``jax.tree.leaves`` order."""
    specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x,
                                                                PartitionSpec))
    leaves = jax.tree.leaves(leaves)
    assert len(specs) == len(leaves), (len(specs), len(leaves))
    return [int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape))
                * np.dtype(x.dtype).itemsize) for x, s in zip(leaves, specs)]


def leaf_bytes(cfg, shape_name, mesh) -> list:
    """One device's bytes of each input leaf of the cell's step, in the
    order of ``build_cell``'s flattened arguments."""
    s = SHAPES[shape_name]
    batch = dryrun.abstract_batch(cfg, shape_name)
    if s.kind == "train":
        opt = AdamW(lr=wsd_schedule(3e-4, 1000, 100_000, 10_000))
        state = jax.eval_shape(lambda k: tsteps.init_train_state(k, cfg, opt),
                               jax.random.key(0))
        return (_bytes(state, shd.state_specs(cfg, state, mesh), mesh)
                + _bytes(batch, shd.batch_specs(cfg, batch, mesh), mesh))
    params = jax.eval_shape(lambda k: lm.init(k, cfg), jax.random.key(0))
    cache = dryrun.abstract_cache(cfg, shape_name)
    pb = _bytes(params, shd.param_specs(cfg, params, mesh), mesh)
    cb = _bytes(cache, shd.cache_specs(cfg, cache, mesh,
                                       seq_shard=s.global_batch == 1), mesh)
    if s.kind == "prefill":
        return pb + _bytes(batch, shd.batch_specs(cfg, batch, mesh), mesh) + cb
    tok = PartitionSpec(shd.data_axes(mesh)) if s.global_batch > 1 \
        else PartitionSpec()
    return pb + _bytes(batch["tokens"], tok, mesh) + cb + [4]  # cache_len


def pruned_bytes(cfg, shape_name, mesh) -> int:
    """The bytes of the inputs the cell's jitted step never reads, which
    ``jax.jit`` drops from the executable (``keep_unused=False``) and so
    from ``memory_analysis().argument_size_in_bytes``: from the lowered
    module's kept arguments."""
    jfn, args = dryrun.build_cell(cfg, shape_name, mesh)
    with mesh:
        kept = set(jfn.lower(*args)._lowering.compile_args["kept_var_idx"])
    sizes = leaf_bytes(cfg, shape_name, mesh)
    assert len(sizes) == len(jax.tree.leaves(args))
    return sum(n for i, n in enumerate(sizes) if i not in kept)


def smoke_config(arch):
    """The arch's smoke config with :data:`SMOKE_CHUNKS`."""
    cfg = get_config(arch, smoke=True)
    ssm = (None if cfg.ssm is None else
           dataclasses.replace(cfg.ssm, chunk=SMOKE_CHUNKS["ssm_chunk"]))
    return dataclasses.replace(cfg, attn_chunk=SMOKE_CHUNKS["attn_chunk"],
                               loss_chunk=SMOKE_CHUNKS["loss_chunk"], ssm=ssm)


def model_flops(cfg, shape_name) -> int:
    mf = 6 if SHAPES[shape_name].kind == "train" else 2
    return mf * lm.active_param_count(cfg) * dryrun._tokens(cfg, shape_name)


def main() -> int:
    t0 = time.time()
    meshes = {m: make_production_mesh(multi_pod=m == "multi") for m in MESHES}
    out = {"cells": {}, "full": {}, "params": {},
           "smoke_chunks": SMOKE_CHUNKS}
    for arch in ARCHS:
        cfg = get_config(arch)
        out["params"][arch] = {"param_count": lm.param_count(cfg),
                               "active_param_count": lm.active_param_count(cfg)}
        for shape_name in SHAPES:
            ok, reason = shape_applicable(cfg, shape_name)
            for m, mesh in meshes.items():
                rec = {"status": "OK" if ok else "SKIP", "reason": reason,
                       "tokens": dryrun._tokens(cfg, shape_name),
                       "model_flops_total": model_flops(cfg, shape_name)}
                if ok:
                    rec["argument_bytes"] = sum(leaf_bytes(cfg, shape_name,
                                                           mesh))
                out["full"][f"{arch}__{shape_name}__{m}"] = rec
    print(f"full-size argument bytes: {time.time() - t0:.1f} s", flush=True)
    for arch, shapes in SMOKE_CELLS.items():
        cfg = smoke_config(arch)
        for shape_name in shapes:
            for m in MESHES:
                rec = dryrun.run_cell(arch, shape_name, m, cfg_override=cfg)
                keep = {k: rec[k] for k in ("status", "reason", "chips",
                                            "error", "wall_s") if k in rec}
                keep["tokens"] = dryrun._tokens(cfg, shape_name)
                keep["model_flops_total"] = model_flops(cfg, shape_name)
                if rec["status"] == "OK":
                    keep["memory"] = rec["memory"]
                    keep["pruned_argument_bytes"] = pruned_bytes(
                        cfg, shape_name, meshes[m])
                    keep["hlo_walk"] = {k: rec["hlo_walk"][k] for k in (
                        "flops", "bytes", "collective_traffic",
                        "collective_count", "unknown_trips")}
                out["cells"][f"{arch}__{shape_name}__{m}"] = keep
                print(f"{arch} x {shape_name} x {m}: {rec['status']} "
                      f"({rec['wall_s']} s) {rec.get('error', '')[:120]}",
                      flush=True)
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
