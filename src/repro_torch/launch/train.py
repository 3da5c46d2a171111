"""Training driver: the counterpart of the reference package's
``launch/train.py``.

Wires the substrate: config registry -> train state (placed on a mesh by
``state_specs``) -> WSD AdamW -> deterministic data -> train step (remat +
grad accumulation) -> checkpoint manager with AUTO-RESUME (restart the
process and it continues from the latest checkpoint and the exact data
position).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 200 --batch 16 --seq 64 --ckpt /tmp/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --data zipf --batch 8 --seq 1024 --steps 20 --warmup 4   # the card
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \\
      --distributed --mesh local|single|multi ...                # sharded

It runs on the CUDA card unless ``--device`` names another device (raises
without a card). Without ``--distributed``, ``--mesh local`` trains on one
device and places nothing.

``--distributed`` is the counterpart of ``jax.distributed.initialize()``:
``torch.distributed.init_process_group`` from the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun``
sets them), NCCL on the card (each process on ``cuda:LOCAL_RANK``), gloo on
the CPU. The state is then sharded over a mesh by ``state_specs`` at the
start and after a resume (:mod:`repro_torch.train.sharded`): ``--mesh
local`` is a 1x1 mesh (a world of one), ``single`` and ``multi`` the
production meshes, which need worlds of 256 and 512 ranks and fail on
another, naming the size. ``--mesh single|multi`` without
``--distributed`` fails the same way (a world of one).

Data: every rank draws the whole global batch of ``--batch`` rows, as
host 0 of 1 (the reference's single-process stream), and keeps its rows:
its data block of each microbatch (``batch_rows``). So a multi-host run
trains on the batches a one-device run draws, whatever the mesh; ranks
along ``"model"`` take the same rows. (The reference on N hosts draws N
per-host streams instead.)

Fault handling: ``--sim-fail N`` checkpoints and raises after N steps (a
restart resumes); a SIGTERM hook checkpoints the latest state and exits
the loop (on a mesh, at the first step after any rank was signalled). A
sharded checkpoint is written by rank 0, gathered by every rank.

Weights are random, drawn from ``torch.Generator(device).manual_seed(0)``
(on every rank alike); the data are the reference's, batch for batch.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import time

import torch
import torch.distributed as dist

from ..api import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..data.pipeline import Prefetcher, SyntheticCopyTask, SyntheticZipfLM
from ..distributed import sharding
from ..optim import AdamW, wsd_schedule
from ..train import sharded
from ..train.steps import init_train_state, make_train_step
from .mesh import make_local_mesh, make_production_mesh

#: Seconds a collective waits before it fails the rank.
GROUP_TIMEOUT_S = 600


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _init_distributed(device: torch.device) -> torch.device:
    """Join the launcher's process group; returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return device


def _mesh(kind: str, device: torch.device):
    if kind == "local":
        return make_local_mesh(1, 1, device_type=device.type)
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type=device.type)


def _any(flag: bool, mesh, device) -> bool:
    """Whether any rank of ``mesh`` has ``flag`` set."""
    if mesh is None or mesh.size() == 1:
        return flag
    t = torch.tensor(int(flag), device=device)
    return bool(sharding.all_reduce(t, None, dist.ReduceOp.MAX))


def main(argv=None, *, on_step=None):
    """Parse ``argv`` (None: the command line), train, return the final
    train state. ``on_step(step, state, metrics)``, where given, is called
    after each step with its number (from 1), the train state and the
    step's metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data", choices=["copy", "zipf"], default="copy")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--sim-fail", type=int, default=0,
                    help="simulate a crash after N steps (restart resumes)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the launcher's process group (multi-host)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if not args.distributed:
        return _train(args, device, on_step)
    device = _init_distributed(device)
    try:
        return _train(args, device, on_step)
    finally:
        dist.destroy_process_group()


def _train(args, device, on_step):
    mesh = (_mesh(args.mesh, device)
            if args.distributed or args.mesh != "local" else None)
    lead = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke)

    opt = AdamW(lr=wsd_schedule(args.lr, args.warmup,
                                max(args.steps - args.warmup - args.steps // 5, 1),
                                max(args.steps // 5, 1)), weight_decay=0.01)
    ds_cls = SyntheticCopyTask if args.data == "copy" else SyntheticZipfLM
    ds = ds_cls(cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0,
                num_hosts=1, host_id=0)

    generator = torch.Generator(device).manual_seed(0)
    if mesh is None:
        state = init_train_state(generator, cfg, opt)
    else:
        state = sharded.init_train_state(generator, cfg, opt, mesh)

    start = 0
    cm = None
    if args.ckpt:
        cm = CheckpointManager(args.ckpt, keep_n=3, async_save=True)
        if cm.latest_step() is not None:
            state = cm.restore_latest(state)
            start = cm.latest_step()
            if lead:
                print(f"[resume] restored step {start} from {args.ckpt}")

    if mesh is None:
        step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)

        def rows(batch):
            return batch
    else:
        step_fn = sharded.make_sharded_train_step(
            cfg, opt, mesh, grad_accum=args.grad_accum)

        def rows(batch):
            return sharded.batch_rows(batch, mesh, args.grad_accum)

    stop = {"flag": False}

    def _sigterm(sig, frame):
        stop["flag"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)

    pre = Prefetcher(ds, start_step=start)
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    try:
        for i in range(start, args.steps):
            step_idx, batch = pre.next()
            assert step_idx == i
            state, m = step_fn(state, {k: torch.from_numpy(v).to(device)
                                       for k, v in rows(batch).items()})
            if on_step is not None:
                on_step(i + 1, state, m)
            if args.sim_fail and i + 1 == args.sim_fail:
                if cm:
                    cm.save(i + 1, state)
                    cm.wait()
                raise RuntimeError(
                    f"[sim-fail] injected failure at step {i + 1}")
            if (i + 1) % args.log_every == 0 and lead:
                _sync(device)
                dt = time.time() - t0
                tps = tokens_per_step * args.log_every / max(dt, 1e-9)
                print(f"step {i+1:5d} loss {float(m['loss']):.4f} "
                      f"gnorm {float(m['grad_norm']):.3f} "
                      f"lr {float(m['lr']):.2e} tok/s {tps:,.0f}", flush=True)
                t0 = time.time()
            stop["flag"] = _any(stop["flag"], mesh, device)
            if cm and ((i + 1) % args.ckpt_every == 0 or stop["flag"]):
                cm.save(i + 1, state)
            if stop["flag"]:
                if lead:
                    print("[sigterm] checkpointed and exiting")
                break
    finally:
        pre.close()
        signal.signal(signal.SIGTERM, previous)
        if cm:
            cm.wait()
    if lead:
        print("done at step", int(sharding.full_tensor(state["step"])))
    return state


if __name__ == "__main__":
    main()
