"""Multi-pod dry-run: every (arch x shape x mesh) cell built, placed and
stepped on the production meshes, 256 and 512 ranks, without a card's worth
of memory: the counterpart of the reference package's ``launch/dryrun.py``
(``docs/dryrun_torch.md``).

The reference lowers and compiles each cell's jitted step on 512 fake host
devices and reads the compiled HLO. The port has no HLO. What stands in for
it is one rank's eager step under ``FakeTensorMode`` (tensors with shapes,
dtypes and a device, and no storage) on a fake process group of the mesh's
size, rank 0 standing for every rank (``fix_divisibility`` keeps the
placements even): the sharded train step
(:func:`repro_torch.train.sharded.make_sharded_train_step`), the sharded
prefill or the greedy decode step (``make_sharded_prefill_step``,
``make_sharded_decode_step``), counted by
:class:`repro_torch.distributed.cost.Analysis`. Kernel 5 launches nothing
on fake tensors and is charged its closed-form work.

Usage (the fake tensors lie on the card unless ``--device cpu``; nothing is
allocated on either):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single multi --out experiments/dryrun_torch --device cpu

One JSON record per cell is written under <out>/; existing records are
skipped (``--force`` redoes them), so the sweep is resumable. The records
keep the reference's keys.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch

from ..api import resolve_device
from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..distributed import collectives, cost
from ..distributed import sharding as shd
from ..models import lm
from ..models.common import ModelConfig
from ..optim import AdamW, wsd_schedule
from ..train import sharded
from .mesh import fake_production_mesh

# NVIDIA H100 SXM 80 GB data-sheet constants for the roofline report, at
# the card's full 700 W power limit (a card set lower runs slower).
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12           # HBM3 bytes/s a card
NVLINK_BW = 450e9          # NVLink bytes/s a card, each way


def _dec_len(cfg: ModelConfig, t: int) -> int:
    """Whisper's decoder length at ``t`` frames."""
    return max(64, t // cfg.encdec.dec_ratio)


class MeshShape(NamedTuple):
    """A stand-in for a production mesh where only its shape is read
    (specs, block shapes, :func:`argument_bytes`): no process group."""
    axis_names: tuple
    shape: dict


def mesh_shape(mesh_name: str) -> MeshShape:
    """The production mesh's axes and sizes (``launch/mesh.py``)."""
    if mesh_name == "multi":
        return MeshShape(("pod", "data", "model"),
                         {"pod": 2, "data": 16, "model": 16})
    return MeshShape(("data", "model"), {"data": 16, "model": 16})


def _rows(b: int, mesh) -> int:
    """Rows of a global batch of ``b`` on a rank: its data block where the
    data ranks divide ``b``, else all (``batch_specs``)."""
    if mesh is None:
        return b
    n = shd._axis_size(mesh, shd.data_axes(mesh))
    return b // n if b % n == 0 else b


def abstract_batch(cfg: ModelConfig, shape_name: str, mesh=None,
                   device="cpu") -> dict:
    """Stand-ins (empty tensors: under ``FakeTensorMode``, fake) for every
    model input of this cell: the rank's rows on ``mesh`` (the global batch
    without one)."""
    s = SHAPES[shape_name]
    b, t = _rows(s.global_batch, mesh), s.seq_len

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    i32, dt = torch.int32, cfg.torch_dtype
    if s.kind == "decode":
        return {"tokens": sds((b,), i32)}
    out = {}
    if cfg.encdec is not None:
        dec = _dec_len(cfg, t)
        out = {"frames": sds((b, t, cfg.d_model), dt),
               "tokens": sds((b, dec), i32)}
        if s.kind == "train":
            out["labels"] = sds((b, dec), i32)
        return out
    if cfg.family == "vlm":
        out["embeds"] = sds((b, t, cfg.d_model), dt)
    else:
        out["tokens"] = sds((b, t), i32)
    if s.kind == "train":
        out["labels"] = sds((b, t), i32)
    return out


def abstract_cache(cfg: ModelConfig, shape_name: str, mesh, device="cpu"):
    """The cell's sharded serve cache (:func:`repro_torch.train.sharded.init_cache`;
    the sequence over the data axes where the global batch is 1)."""
    s = SHAPES[shape_name]
    b, t = s.global_batch, s.seq_len
    if cfg.encdec is not None:
        return sharded.init_cache(cfg, b, _dec_len(cfg, t), mesh,
                                  seq_shard=b == 1, enc_len=t, device=device)
    return sharded.init_cache(cfg, b, t, mesh, seq_shard=b == 1,
                              device=device)


def _placed_params(cfg: ModelConfig, mesh, device, dtype=None) -> dict:
    """Empty blocks of every parameter placed by ``param_specs`` (in
    ``dtype``, or each parameter's own), by name."""
    meta = lm.LM(cfg, device="meta")
    specs = shd.param_specs(cfg, meta, mesh)
    shards = shd.to_shardings(mesh, specs)
    return {n: shd.from_local(
        torch.empty(shd.shard_shape(tuple(p.shape), specs[n], mesh),
                    dtype=dtype or p.dtype, device=device),
        shards[n], tuple(p.shape)) for n, p in meta.named_parameters()}


def _scalar(mesh, device):
    return shd.from_local(torch.zeros((), dtype=torch.int32, device=device),
                          shd.to_shardings(mesh, shd.P()), ())


def build_cell(cfg: ModelConfig, shape_name: str, mesh, device="cpu"):
    """Returns (step, example arguments) for one rank: the train state and
    the rank's rows; the parameters, the rows and the cache; or the
    parameters, the rank's tokens, the cache and ``cache_len`` (the cache
    full but one position: ``seq_len - 1``)."""
    s = SHAPES[shape_name]
    batch = abstract_batch(cfg, shape_name, mesh, device)
    if s.kind == "train":
        opt = AdamW(lr=wsd_schedule(3e-4, 1000, 100_000, 10_000))
        f32 = torch.float32
        state = {"params": sharded._sharded_lm(
                     cfg, _placed_params(cfg, mesh, device)),
                 "opt": {"m": _placed_params(cfg, mesh, device, f32),
                         "v": _placed_params(cfg, mesh, device, f32),
                         "master": _placed_params(cfg, mesh, device, f32),
                         "count": _scalar(mesh, device)},
                 "step": _scalar(mesh, device)}
        fn = sharded.make_sharded_train_step(cfg, opt, mesh,
                                             grad_accum=cfg.grad_accum)
        return fn, (state, batch)
    params = sharded._sharded_lm(cfg, _placed_params(cfg, mesh, device))
    cache = abstract_cache(cfg, shape_name, mesh, device)
    if s.kind == "prefill":
        return sharded.make_sharded_prefill_step(cfg, mesh), (params, batch,
                                                             cache)
    length = _dec_len(cfg, s.seq_len) if cfg.encdec is not None else s.seq_len
    return (sharded.make_sharded_decode_step(cfg, mesh),
            (params, batch["tokens"], cache, length - 1))


def argument_bytes(cfg: ModelConfig, shape_name: str, mesh) -> int:
    """The rank's bytes of every input of the cell's step, summed from the
    specs' block shapes on the meta device (no process group, nothing run:
    ``mesh`` may be a :class:`MeshShape`): what :func:`run_cell` records as
    ``memory.argument_size_in_bytes``."""
    s = SHAPES[shape_name]
    meta = lm.LM(cfg, device="meta")
    specs = shd.param_specs(cfg, meta, mesh)
    blocks = {n: math.prod(shd.shard_shape(tuple(p.shape), specs[n], mesh))
              for n, p in meta.named_parameters()}
    params = sum(blocks[n] * p.element_size()
                 for n, p in meta.named_parameters())
    rows = _bytes(abstract_batch(cfg, shape_name, mesh, "meta"))
    if s.kind == "train":                 # m, v and master in f32; 2 ints
        return params + 12 * sum(blocks.values()) + 8 + rows
    b, t = s.global_batch, s.seq_len
    if cfg.encdec is not None:
        cache = lm.encdec_init_cache(cfg, b, _dec_len(cfg, t), t,
                                     device="meta")
    else:
        cache = lm.init_cache(cfg, b, t, device="meta")
    cspecs = shd.cache_specs(cfg, cache, mesh, seq_shard=b == 1)
    nbytes = sharded._zip_map(
        lambda leaf, spec: math.prod(shd.shard_shape(tuple(leaf.shape), spec,
                                                     mesh))
        * leaf.element_size(), cache, cspecs)
    return params + sum(sharded._leaves(nbytes)) + rows + (
        4 if s.kind == "decode" else 0)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in cost.local_tensors(tree))


def argument_size(args) -> int:
    """The rank's bytes of every input: its blocks of each tensor, and an
    int (``cache_len``) as the reference's int32 scalar."""
    return _bytes(args) + sum(4 for a in args if isinstance(a, int))


def _memory(args, out, peak: int) -> dict:
    """``memory_analysis()``'s keys from the rank's tensors: the arguments,
    the outputs (``alias``: those that are arguments' storage, updated in
    place, as a donated argument), and the peak of live storage over the
    step (``temp``: the peak less the arguments and the outputs that are
    not arguments)."""
    held = {t.untyped_storage()._cdata for t in cost.local_tensors(args)}
    outs = cost.local_tensors(out)
    output = sum(t.numel() * t.element_size() for t in outs)
    alias = sum(t.numel() * t.element_size() for t in outs
                if t.untyped_storage()._cdata in held)
    argument = argument_size(args)
    return {"argument_size_in_bytes": argument,
            "output_size_in_bytes": output,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": max(0, peak - argument - (output - alias)),
            "peak_bytes": peak}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             cfg_override: ModelConfig | None = None,
             want_profile: bool = False, device=None) -> dict:
    """One cell's record. ``device`` None = the card (raises without one);
    the fake tensors lie there, and nothing is allocated."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    ok, reason = shape_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="SKIP", reason=reason, wall_s=0.0)
        return rec
    device = resolve_device(device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    try:
        with fake_production_mesh(multi_pod=mesh_name == "multi",
                                  device_type=device.type) as mesh, \
                FakeTensorMode():
            chips = mesh.size()
            shd.reset_stats()
            fn, args = build_cell(cfg, shape_name, mesh, device)
            t_build = time.time() - t0
            with cost.Analysis() as a:
                a.track(args)
                out = fn(*args)
            t_step = time.time() - t0 - t_build
            mem = _memory(args, out, a.peak_bytes)
            walk = a.result()
            coll = collectives.collective_bytes(a.records())
            route = shd.route(mesh, device)
            del out, args, fn
        flops, bytes_acc = walk["flops"], walk["bytes"]
        kind = SHAPES[shape_name].kind
        mf = 6 if kind == "train" else 2      # fwd+bwd vs fwd-only per token
        model_flops = mf * lm.active_param_count(cfg) * _tokens(cfg,
                                                                 shape_name)
        rec.update(
            status="OK", chips=chips, route=route,
            lower_s=round(t_build, 1), compile_s=round(t_step, 1),
            cost={"flops": flops, "bytes accessed": bytes_acc},
            memory=mem, collectives=coll, hlo_walk=walk,
            roofline={
                "compute_s": flops / PEAK_FLOPS,
                "memory_s": bytes_acc / HBM_BW,
                "collective_s": walk["collective_traffic"] / NVLINK_BW,
                "model_flops_total": model_flops,
                "useful_flops_frac": ((model_flops / chips) / flops
                                      if flops else None),
            })
        if want_profile:
            rec["profile"] = a.profile()
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _tokens(cfg, shape_name):
    s = SHAPES[shape_name]
    if s.kind == "train":
        if cfg.encdec is not None:
            return s.global_batch * (s.seq_len + _dec_len(cfg, s.seq_len))
        return s.global_batch * s.seq_len
    if s.kind == "prefill":
        return s.global_batch * s.seq_len
    return s.global_batch  # decode: one token per sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single"],
                    choices=["single", "multi"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    archs = list(ARCHS) if args.arch == ["all"] else args.arch
    shapes = list(SHAPES) if args.shape == ["all"] else args.shape
    os.makedirs(args.out, exist_ok=True)

    for mesh_name in args.mesh:
        for arch in archs:
            for shape_name in shapes:
                path = os.path.join(args.out,
                                    f"{arch}__{shape_name}__{mesh_name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"skip (exists): {path}")
                    continue
                print(f"=== {arch} x {shape_name} x {mesh_name} ===",
                      flush=True)
                rec = run_cell(arch, shape_name, mesh_name, device=device)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "OK":
                    r = rec["roofline"]
                    extra = (f" compute={r['compute_s']:.4f}s "
                             f"memory={r['memory_s']:.4f}s "
                             f"coll={r['collective_s']:.4f}s")
                elif status == "FAIL":
                    extra = " " + rec["error"][:160]
                print(f"--- {status} ({rec['wall_s']}s){extra}", flush=True)


if __name__ == "__main__":
    main()
