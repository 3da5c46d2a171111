"""Architecture registry and input shapes: a copy of the reference
package's ``repro/configs/registry.py`` over the port's own config modules
(plain dataclasses, no weights).

ARCHS lists the arch ids; ``get_config`` gives the full or the reduced smoke
ModelConfig of each. SHAPES are the four (seq_len, global_batch, kind) cells.
``shape_applicable`` keeps the reference's skip rules:
  * ``long_500k`` only for sub-quadratic archs (SSM state or MLA latent
    cache); pure full-attention archs skip it.
  * all archs here are decoder-bearing, so decode shapes always apply.

Every arch has a config here, and the port's model serves and trains every
family of them: dense, MoE, VLM, SSM, hybrid and encoder-decoder
(:mod:`repro_torch.models.lm`).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "gemma-2b": "gemma_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-130m": "mamba2_130m",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(applicable, reason-if-not)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 512K dense KV cache is the quadratic regime (DESIGN.md)"
    return True, ""


def input_specs(arch: str, shape: str):
    """Raw (seq_len, batch, kind) plus per-arch semantics adjustments.

    Whisper: seq_len == encoder frames; decoder length = seq_len // dec_ratio
    (train/prefill) and decode steps use a seq_len//dec_ratio-deep self cache.
    VLM: train/prefill inputs are stub patch embeddings [b, t, d_model].
    """
    cfg = get_config(arch)
    s = SHAPES[shape]
    spec = {"arch": arch, "shape": shape, "kind": s.kind,
            "seq_len": s.seq_len, "global_batch": s.global_batch}
    if cfg.encdec is not None:
        spec["enc_len"] = s.seq_len
        spec["dec_len"] = max(64, s.seq_len // cfg.encdec.dec_ratio)
    if cfg.family == "vlm":
        spec["embeds"] = True
    return spec
