"""Model config schema, parameter init helpers, norms, activations, RoPE,
M-RoPE and sinusoidal positions.

The counterpart of the reference package's ``repro/models/common.py``. The
config dataclasses are a plain copy (they hold no arrays); ``torch_dtype``
stands beside ``jdtype``. Initialisers draw from an explicit
``torch.Generator``: they give other numbers than the reference's
``jax.random`` keys from the same seed, so parity tests hand both sides the
same numpy weights (:func:`repro_torch.convert.numpy_lm_params`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Config schema
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading layers use a dense FFN (DeepSeek)
    # capacity-cut policy: "criticality" keeps the highest-router-weight
    # assignments per expert; "arrival" is FCFS token order.
    dispatch_order: str = "criticality"
    # Pin the dispatch tensor's expert dim to the model axis (serve paths of
    # the sharded reference only).
    ep_constraint: bool = False


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 0         # 0 == full-rank queries (V2-Lite)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128             # SSD chunk length
    compute_dtype: str = "float32"  # SSD einsum operand dtype


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    dec_ratio: int = 8           # decoder len = seq_len // dec_ratio (shapes)
    frontend: str = "stub"       # conv frontend stubbed: input = frame embeds


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    proj_bias: bool = False      # biases on out-proj and MLP (whisper)
    mlp_glu: bool = True         # gated MLP; False = plain 2-matrix MLP
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    pos: str = "rope"            # rope | mrope | sinusoid | none
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    encdec: Optional[EncDecCfg] = None
    attn_every: int = 0          # hybrid: shared attn block every k layers
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024       # blockwise attention kv-chunk length
    loss_chunk: int = 2048       # chunked cross-entropy sequence chunk
    scan_layers: bool = True
    fsdp: bool = False           # shard params+opt over the data axis too
    grad_accum: int = 1          # microbatch accumulation in train_step
    vocab_pad_to: int = 256      # embedding tables padded for TP divisibility

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m if m else self.vocab_size

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: per-token decode state is O(1) or O(rank)."""
        return self.ssm is not None or self.mla is not None

    @property
    def jdtype(self) -> np.dtype:
        """The reference's array dtype as a numpy dtype (bfloat16 comes from
        ``ml_dtypes``); the port itself uses :attr:`torch_dtype`."""
        if self.dtype == "bfloat16":
            import ml_dtypes  # noqa: PLC0415
            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def block_kind(self, i: int) -> str:
        """Block type of layer i: attn | moe | mamba | shared_attn."""
        if self.ssm is not None and self.attn_every == 0:
            return "mamba"
        if self.ssm is not None:
            return "shared_attn" if (i + 1) % self.attn_every == 0 else "mamba"
        if self.moe is not None:
            return "attn" if i < self.moe.first_dense_layers else "moe"
        return "attn"


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def dense_init(generator, shape, dtype, scale: float | None = None):
    """Normal weights scaled by 1/sqrt(fan_in) (``shape[0]``), drawn in f32
    on the generator's device, then cast."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * s).to(dtype)


def embed_init(generator, shape, dtype):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rmsnorm(x, weight, eps):
    xf = x.float()
    nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (nrm * weight.float()).to(x.dtype)


def layernorm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# --------------------------------------------------------------------------
# Per-device constants
# --------------------------------------------------------------------------

def _fake_mode():
    """The active fake tensor mode (the dry-run's), or None."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def per_device(fn=None, *, maxsize=None):
    """``fn(..., device)`` made once per arguments and kept (the last
    ``maxsize``; a copy from the host on every call would synchronise the
    host with the card). Under a fake tensor mode the tensor is kept on the
    mode itself: a fake tensor must not outlive its mode in a cache."""
    if fn is None:
        return functools.partial(per_device, maxsize=maxsize)
    cached = functools.lru_cache(maxsize=maxsize)(fn)

    @functools.wraps(fn)
    def get(*args):
        mode = _fake_mode()
        if mode is None:
            return cached(*args)
        made = mode.__dict__.setdefault("_per_device", {})
        key = (fn.__qualname__, args)
        if key not in made:
            made[key] = fn(*args)
        return made[key]

    return get


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@per_device
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # Made once per device: a copy from the host on every call would
    # synchronise the host with the card twice a layer.
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: [B, H, T, D], positions: [B, T] int -> rotated x. Rotates the two
    halves of the head (not interleaved pairs), with the angles in f32."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                      # [D/2]
    ang = positions[:, None, :, None].float() * freqs               # [B,1,T,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


MROPE_SECTIONS = (16, 24, 24)  # qwen2-vl: (temporal, height, width) freq split


@per_device
def _mrope_streams_on(half: int, sections: tuple, device: torch.device):
    # The stream (0 temporal, 1 height, 2 width) of each of the ``half``
    # frequency channels, built on the host as the reference builds it:
    # channel i takes ``i % sum(sections)`` against the sections' cumulative
    # bounds, clamped to 2.
    bounds = np.cumsum(sections)
    sec = np.searchsorted(bounds, np.arange(half) % bounds[-1], side="right")
    return torch.from_numpy(np.minimum(sec, 2)).to(device)


def apply_mrope(x, positions3, theta: float, sections=MROPE_SECTIONS):
    """Multimodal RoPE: x [B, H, T, D], positions3 [B, 3, T] (t/h/w ids).
    Each frequency channel turns by the position stream of its section; for
    text tokens the three ids are equal and this is :func:`apply_rope`."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                      # [D/2]
    sec = _mrope_streams_on(d // 2, tuple(sections), x.device)
    pos = positions3.float()[:, sec, :]                             # [B,D/2,T]
    ang = pos.transpose(1, 2)[:, None] * freqs                      # [B,1,T,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# --------------------------------------------------------------------------

@per_device(maxsize=16)
def _sinusoid_on(t: int, d: int, offset: int, device: torch.device):
    # Built on the host in numpy float32 as the reference builds it, once
    # per shape and device (as the RoPE frequencies are).
    pos = np.arange(offset, offset + t, dtype=np.float32)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, d, 2, dtype=np.float32) / d)
    pe = np.zeros((t, d), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def sinusoid_positions(t: int, d: int, offset: int = 0, *, device):
    """[t, d] float32 sinusoids of positions ``offset .. offset + t - 1`` on
    ``device``: sin in the even columns, cos in the odd, at frequencies
    ``10000 ** (-2i / d)``; the reference's numbers. The tensor is shared
    between calls: do not write into it."""
    return _sinusoid_on(int(t), int(d), int(offset), torch.device(device))
