"""Batched serving driver: prefill a prompt batch, decode N tokens greedily,
report throughput. The counterpart of the reference package's
``launch/serve.py``, for every family of the registry. A VLM's prompt is
stub patch embeddings ``[batch, prompt, d_model]``, as in the reference;
whisper's encoder input is stub frame embeddings ``[batch, 2 x prompt,
d_model]`` (the reference fixes the frames at twice the decoder prompt),
its decoder prompt tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 8 --prompt-len 2048 --gen 32          # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \\
      --layers 16 --batch 8 --prompt-len 2048 --gen 32   # depth cut to fit
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --batch 8 --prompt-len 750 --gen 32  # 1,500 frames
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --device cpu --batch 2 --prompt-len 8 --gen 4

Besides the rates it prints the prefill's ``moe_dropped``: the routed
assignments its MoE layers dropped at the capacity cut (0 for a dense
model).

Weights are random, drawn from ``torch.Generator(device).manual_seed(0)``;
prompt tokens (or a VLM's embeddings; whisper's frames, drawn before its
tokens) come from ``np.random.default_rng(0)``, as in the reference.
``--layers N`` keeps the first N layers (a depth cut, for a model the card
cannot hold whole); the widths stay the config's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..api import resolve_device
from ..configs import get_config
from ..models import lm
from ..train.steps import make_decode_step, make_prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (default: all)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        if not 0 < args.layers <= cfg.num_layers:
            raise ValueError(f"--layers must lie in [1, {cfg.num_layers}]")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = lm.init(torch.Generator(device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    b, p, gen = args.batch, args.prompt_len, args.gen

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, greedy=args.greedy)

    def normal(t):
        return torch.from_numpy(rng.standard_normal(
            (b, t, cfg.d_model))).to(device, cfg.torch_dtype)

    def tokens():
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, p)).astype(np.int32)).to(device)

    if cfg.encdec is not None:
        batch = {"frames": normal(2 * p)}        # drawn before the tokens
        batch["tokens"] = tokens()
        cache = lm.encdec_init_cache(cfg, b, max_dec_len=p + gen,
                                     enc_len=2 * p, device=device)
    else:
        batch = ({"embeds": normal(p)} if cfg.family == "vlm"
                 else {"tokens": tokens()})
        cache = lm.init_cache(cfg, b, max_len=p + gen, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache, metrics = prefill(params, batch, cache,
                                     return_metrics=True)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    cur = torch.argmax(logits, -1).to(torch.int32)
    outs = [cur]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        cur, _, cache = decode(params, cur, cache, p + i)
        outs.append(cur)
    _sync(device)
    t_decode = time.perf_counter() - t0
    seq = torch.stack(outs, 1).cpu().numpy()

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} batch={b} prompt={p} gen={gen}")
    print(f"prefill: {t_prefill*1e3:.1f} ms  ({b*p/t_prefill:,.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms   ({b*(gen-1)/max(t_decode,1e-9):,.0f} tok/s)")
    print(f"prefill moe_dropped: {int(metrics['moe_dropped'].item())}")
    print("sample tokens:", seq[0, :12].tolist())
    print(f"device: {name}")
    return seq


if __name__ == "__main__":
    main()
