"""Blockwise (flash) attention: the CUDA kernel and its plain torch version.

The wrapper replaces the Pallas TPU kernel of the reference package's
``kernels/flash_attention.py`` (``flash_attention``), extended by one
argument, ``kv_len``, so that it also computes the decode case of the
reference's portable ``models/attention.py::blockwise_attention``:

  * :func:`attention` takes the model stack's token-major layout, q
    ``[B, Tq, Hq, D]`` and k/v ``[B, Tkv, Hkv, D]``;
  * :func:`flash_attention` takes the Pallas kernel's head-major layout,
    ``[B, H, T, D]``.

For batch row b and q head h (which reads kv head ``h // rep``), q row i
attends to the keys ``j < kv_len[b]``, and under ``causal`` (ends aligned,
the decode convention) also ``j <= i + kv_len[b] - Tq``. Accumulation is in
f32 and the output has q's dtype (float32 or bfloat16).

A tensor on the CPU goes to the plain version (:func:`attention_plain`), the
reference's online-softmax arithmetic over kv chunks with the same masks; a
CUDA tensor launches the kernel of ``csrc/flash_attention.cu`` on the
current stream, or raises. There is no fallback. :data:`launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = "flash_attention.cu"
NEG = -1e30                     # the reference's mask value

#: Kernel launches since the last :func:`reset_launches`.
launches: dict[str, int] = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kv_lengths(kv_len, b: int, tkv: int) -> list[int]:
    """``kv_len`` (None = Tkv, an int, or a [] or [B] tensor, array or
    sequence) as B host ints. A tensor on the card is read to the host (a
    synchronisation); the serving path passes an int."""
    if kv_len is None:
        return [tkv] * b
    if hasattr(kv_len, "tolist"):                       # tensor or array
        kv_len = kv_len.tolist()
    if isinstance(kv_len, (list, tuple)):
        lens = [int(x) for x in kv_len]
        if len(lens) != b:
            raise ValueError(f"kv_len has {len(lens)} entries for batch {b}")
        return lens
    return [int(kv_len)] * b


# ---------------------------------------------------------------------------
# Plain version.
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, *, causal=True, scale=None, kv_len=None,
                    kv_chunk=1024):
    """q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] -> [B, Tq, Hq, D]: the
    reference's online softmax in f32 over kv chunks of ``kv_chunk`` keys
    (score -1e30 where masked, then exp), up to the largest ``kv_len``."""
    b, tq, hq, d = q.shape
    tkv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    lens = kv_lengths(kv_len, b, tkv)
    dev = q.device
    kvl = torch.tensor(lens, dtype=torch.int64, device=dev)
    qpos = torch.arange(tq, device=dev)[None, :] + (kvl - tq)[:, None]  # [B, Tq]
    qf = q.float().reshape(b, tq, hkv, rep, d)
    m = torch.full((b, hkv, rep, tq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, rep, tq, d), dtype=torch.float32, device=dev)
    ck = min(kv_chunk, tkv)
    for k0 in range(0, min(max(lens), tkv), ck):
        kc = k[:, k0:k0 + ck].float()
        vc = v[:, k0:k0 + ck].float()
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc) * s
        kpos = torch.arange(k0, k0 + kc.shape[1], device=dev)
        mask = (kpos[None, :] < kvl[:, None])[:, None, :]             # [B, 1, ck]
        if causal:
            mask = mask & (qpos[:, :, None] >= kpos[None, None, :])   # [B, Tq, ck]
        sc = torch.where(mask[:, None, None], sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]                  # [B,G,R,Tq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_attention.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "kv_len")]
                + [(f"{t}_s{x}", ctypes.c_int64) for t in "qkvo" for x in "bth"]
                + [(n, ctypes.c_int32) for n in ("B", "Tq", "Tkv", "Hq", "Hkv",
                                                 "D", "kv_len_all", "causal",
                                                 "dtype")]
                + [("scale", ctypes.c_float)])


def _check(q, k, v, causal, lens):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: [B, T, H, D]")
    b, tq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    tkv, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "attention has no backward yet: call it under torch.no_grad() "
            "(training is ROADMAP queue 1 item 12g)")
    if any(n < 1 or n > tkv for n in lens):
        raise ValueError(f"kv_len must lie in [1, {tkv}], got {lens}")
    if causal and any(n < tq for n in lens):
        # Such a row sees no key, and the reference's two attention
        # functions disagree there.
        raise ValueError(f"causal attention needs kv_len >= Tq = {tq}, got "
                         f"{lens}")
    return q.device.type == "cuda"


def _check_layout(*ts):
    for t in ts:
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"the kernel needs D contiguous and the other strides "
                f"multiples of 8 elements, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")


def attention(q, k, v, *, causal=True, scale=None, kv_len=None,
              kv_chunk=1024):
    """q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] -> [B, Tq, Hq, D] in q's
    dtype. ``kv_len`` ([] or [B], default Tkv) bounds the valid keys of each
    batch row; under ``causal`` it must be at least Tq. ``kv_chunk`` is the
    plain version's chunk (the kernel tiles by 64 keys)."""
    b, tq, _, d = q.shape
    lens = kv_lengths(kv_len, b, k.shape[1])
    if not _check(q, k, v, causal, lens):
        return attention_plain(q, k, v, causal=causal, scale=scale,
                               kv_len=lens, kv_chunk=kv_chunk)
    if d % 8 or d > 256:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to "
                         f"256, got {d}")
    _check_layout(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    uniform = all(n == lens[0] for n in lens)
    kvl = None if uniform else torch.tensor(lens, dtype=torch.int32).to(q.device)
    args = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 o=out.data_ptr(), kv_len=None if kvl is None else kvl.data_ptr(),
                 B=b, Tq=tq, Tkv=k.shape[1], Hq=q.shape[2], Hkv=k.shape[2], D=d,
                 kv_len_all=lens[0], causal=int(causal), dtype=_DTYPES[q.dtype],
                 scale=scale if scale is not None else 1.0 / math.sqrt(d))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
        for x, s in zip("bth", t.stride()[:3]):
            setattr(args, f"{name}_s{x}", s)
    with torch.cuda.device(q.device):
        fn = _build.library(SOURCE).flash_attention_fwd
        launches["flash_attention"] += 1
        rc = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out


def flash_attention(q, k, v, *, causal=True, scale=None, kv_len=None):
    """The Pallas kernel's layout: q [B, Hq, Tq, D], k/v [B, Hkv, Tkv, D] ->
    [B, Hq, Tq, D]. Views into :func:`attention`; nothing is copied."""
    return attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=causal, scale=scale, kv_len=kv_len).transpose(1, 2)
