"""Training driver: the counterpart of the reference package's
``launch/train.py``.

Wires the substrate: config registry -> train state -> WSD AdamW ->
deterministic host-sharded data -> train step (remat + grad accumulation)
-> checkpoint manager with AUTO-RESUME (restart the process and it
continues from the latest checkpoint and the exact data position).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 200 --batch 16 --seq 64 --ckpt /tmp/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --data zipf --batch 8 --seq 1024 --steps 20 --warmup 4   # the card

It runs on the CUDA card unless ``--device`` names another device (raises
without a card). One device: ``--mesh local`` places nothing. A sharded
state (``--mesh single|multi``) and ``--distributed`` are ROADMAP item
12g.8 and raise ``NotImplementedError``.

Fault handling: ``--sim-fail N`` checkpoints and raises after N steps (a
restart resumes); a SIGTERM hook checkpoints the latest state and exits
the loop.

Weights are random, drawn from ``torch.Generator(device).manual_seed(0)``;
the data are the reference's, batch for batch.
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from ..api import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..data.pipeline import Prefetcher, SyntheticCopyTask, SyntheticZipfLM
from ..optim import AdamW, wsd_schedule
from ..train.steps import init_train_state, make_train_step

SHARDED = ("a sharded train state (--mesh single|multi, --distributed) is "
           "ROADMAP queue 1 item 12g.8, not ported yet")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
                    help="multi-host (ROADMAP item 12g.8; raises)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.distributed or args.mesh != "local":
        raise NotImplementedError(SHARDED)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)

    opt = AdamW(lr=wsd_schedule(args.lr, args.warmup,
                                max(args.steps - args.warmup - args.steps // 5, 1),
                                max(args.steps // 5, 1)), weight_decay=0.01)
    ds_cls = SyntheticCopyTask if args.data == "copy" else SyntheticZipfLM
    ds = ds_cls(cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0,
                num_hosts=1, host_id=0)

    state = init_train_state(torch.Generator(device).manual_seed(0), cfg, opt)

    start = 0
    cm = None
    if args.ckpt:
        cm = CheckpointManager(args.ckpt, keep_n=3, async_save=True)
        if cm.latest_step() is not None:
            state = cm.restore_latest(state)
            start = cm.latest_step()
            print(f"[resume] restored step {start} from {args.ckpt}")

    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)

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
                                       for k, v in batch.items()})
            if on_step is not None:
                on_step(i + 1, state, m)
            if args.sim_fail and i + 1 == args.sim_fail:
                if cm:
                    cm.save(i + 1, state)
                    cm.wait()
                raise RuntimeError(
                    f"[sim-fail] injected failure at step {i + 1}")
            if (i + 1) % args.log_every == 0:
                _sync(device)
                dt = time.time() - t0
                tps = tokens_per_step * args.log_every / max(dt, 1e-9)
                print(f"step {i+1:5d} loss {float(m['loss']):.4f} "
                      f"gnorm {float(m['grad_norm']):.3f} "
                      f"lr {float(m['lr']):.2e} tok/s {tps:,.0f}", flush=True)
                t0 = time.time()
            if cm and ((i + 1) % args.ckpt_every == 0 or stop["flag"]):
                cm.save(i + 1, state)
            if stop["flag"]:
                print("[sigterm] checkpointed and exiting")
                break
    finally:
        pre.close()
        signal.signal(signal.SIGTERM, previous)
        if cm:
            cm.wait()
    print("done at step", int(state["step"]))
    return state


if __name__ == "__main__":
    main()
