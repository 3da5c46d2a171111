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
current stream, or raises. There is no fallback. Fake tensors (the
dry-run's, ``FakeTensorMode``), and only they, launch nothing: the call
returns an output of the kernel's shape and dtype and charges the running
:class:`repro_torch.distributed.cost.Analysis` the kernel's closed-form work
(:func:`work`), never the plain version's ``[B, H, Tq, Tkv]`` scores.

The kernel has three bodies, and :func:`plan` alone picks one from the
dtype and the shape: ``"split"`` where a (batch row, kv head) has at most 16
rows (Tq x rep; decode), for both dtypes: the keys cut into chunks over
enough CTAs to fill the card, then a combine kernel; ``"mma"`` for bfloat16
otherwise (prefill on the tensor cores, P rounded to bfloat16 for the P V
product); ``"simt"`` for float32 otherwise (both products in f32 on the CUDA
cores, which the f32 tolerances need). :func:`attention_split_plain` is the
plain version of the split-and-combine arithmetic. :data:`launches` counts
calls (``"flash_attention"``) and each body's kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

SOURCE = "flash_attention.cu"
NEG = -1e30                     # the reference's mask value

#: Calls that launched the kernel (``"flash_attention"``) and launches of
#: each body's kernel since the last :func:`reset_launches`.
launches: dict[str, int] = {"flash_attention": 0, "flash_attention_mma": 0,
                            "flash_attention_split": 0,
                            "flash_attention_combine": 0,
                            "flash_attention_simt": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = {"simt": 0, "mma": 1, "split": 2}

#: The split body takes at most this many rows (Tq x rep) per (b, kv head).
SPLIT_ROWS = 16
#: Keys of a split are a multiple of this many.
SPLIT_KEYS = 64
#: The split body aims at this many CTAs, four for each of the H100's 132
#: SMs: at qwen2-0.5b's decode 33 chunks of 64 keys, faster than 17 of 128
#: or 9 of 256 (PERF.md).
SPLIT_TARGET_CTAS = 528


class Plan(NamedTuple):
    """Which body runs: ``"mma"``, ``"split"`` or ``"simt"``; the split
    body's key chunks (``splits`` of ``chunk`` keys)."""
    body: str
    splits: int = 1
    chunk: int = 0


def plan(b: int, tq: int, tkv: int, hq: int, hkv: int, d: int, dtype,
         lens=None) -> Plan:
    """The body for one call, from host ints only (no synchronisation).
    ``lens`` are the B key counts (None: Tkv each). Rows per (b, kv head)
    are Tq x rep: at most :data:`SPLIT_ROWS` take the split body, its keys
    (up to the largest of ``lens``) cut into about
    ceil(:data:`SPLIT_TARGET_CTAS` / (B x Hkv)) chunks of whole 64-key
    tiles, so that B x Hkv x splits CTAs fill the card; more rows take
    ``"mma"`` in bfloat16 and ``"simt"`` in float32."""
    if tq * (hq // hkv) <= SPLIT_ROWS:
        hi = max(lens) if lens else tkv
        tiles = -(-hi // SPLIT_KEYS)
        want = -(-SPLIT_TARGET_CTAS // (b * hkv))
        per = -(-tiles // want)
        return Plan("split", -(-tiles // per), per * SPLIT_KEYS)
    if dtype == torch.bfloat16:
        return Plan("mma")
    return Plan("simt")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kv_lengths(kv_len, b: int, tkv: int) -> list[int]:
    """``kv_len`` (None = Tkv, an int, or a [] or [B] tensor, array or
    sequence) as B host ints. A tensor on the card is read to the host (a
    synchronisation); the serving path passes an int."""
    if kv_len is None:
        return [tkv] * b
    if isinstance(kv_len, int):
        return [kv_len] * b
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

def _masked_chunks(q, k, v, causal, scale, kv_len, chunk):
    """The plain versions' chunks of ``chunk`` keys up to the largest
    ``kv_len``: (scores [B, G, R, Tq, ck] in f32 with -1e30 where masked,
    whether each row sees a key of the chunk [B, 1, 1, Tq or 1], values
    [B, ck, G, D] in f32)."""
    b, tq, hq, d = q.shape
    tkv, hkv = k.shape[1], k.shape[2]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    lens = kv_lengths(kv_len, b, tkv)
    dev = q.device
    kvl = torch.tensor(lens, dtype=torch.int64, device=dev)
    qpos = torch.arange(tq, device=dev)[None, :] + (kvl - tq)[:, None]  # [B, Tq]
    qf = q.float().reshape(b, tq, hkv, hq // hkv, d)
    for k0 in range(0, min(max(lens), tkv), chunk):
        kc = k[:, k0:k0 + chunk].float()
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc) * s
        kpos = torch.arange(k0, k0 + kc.shape[1], device=dev)
        mask = (kpos[None, :] < kvl[:, None])[:, None, :]             # [B, 1, ck]
        if causal:
            mask = mask & (qpos[:, :, None] >= kpos[None, None, :])   # [B, Tq, ck]
        yield (torch.where(mask[:, None, None], sc, NEG),
               mask.any(-1)[:, None, None], v[:, k0:k0 + chunk].float())


def _finish(q, acc, l):
    """acc [B, G, R, Tq, D] / l -> [B, Tq, Hq, D] in q's dtype."""
    b, tq, hq, d = q.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d).to(q.dtype)


def attention_plain(q, k, v, *, causal=True, scale=None, kv_len=None,
                    kv_chunk=1024):
    """q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] -> [B, Tq, Hq, D]: the
    reference's online softmax in f32 over kv chunks of ``kv_chunk`` keys
    (score -1e30 where masked, then exp), up to the largest ``kv_len``."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    m = torch.full((b, hkv, hq // hkv, tq), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, d), dtype=torch.float32, device=q.device)
    for sc, _, vc in _masked_chunks(q, k, v, causal, scale, kv_len,
                                    min(kv_chunk, k.shape[1])):
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vc)
        m = m_new
    return _finish(q, acc, l)


def attention_split_plain(q, k, v, *, causal=True, scale=None, kv_len=None,
                          chunk=128):
    """The split body's arithmetic: a partial (m, l, acc) for each key range
    of ``chunk`` keys up to the largest ``kv_len``, then their combine in
    the order of the ranges. A row that sees none of a range's keys gives
    m = -1e30, l = 0, acc = 0 there. The same function as
    :func:`attention_plain`, up to f32 rounding."""
    parts = []
    for sc, live, vc in _masked_chunks(q, k, v, causal, scale, kv_len, chunk):
        m = sc.amax(-1)
        p = torch.where(live[..., None], torch.exp(sc - m[..., None]), 0.0)
        parts.append((torch.where(live, m, NEG), p.sum(-1),
                      torch.einsum("bgrqk,bkgd->bgrqd", p, vc)))
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    l_all, acc = 0.0, 0.0
    for m, l, a in parts:
        w = torch.exp(m - m_all)
        l_all = l_all + w * l
        acc = acc + w[..., None] * a
    return _finish(q, acc, l_all)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_attention.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("q", "k", "v", "o", "kv_len", "scratch")]
                + [(f"{t}_s{x}", ctypes.c_int64) for t in "qkvo" for x in "bth"]
                + [(n, ctypes.c_int32) for n in ("B", "Tq", "Tkv", "Hq", "Hkv",
                                                 "D", "kv_len_all", "causal",
                                                 "dtype", "body", "splits",
                                                 "chunk")]
                + [("scale", ctypes.c_float)])


_entry = None       # (flash_attention_fwd, flash_attention_combine)


def _entry_points():
    global _entry
    if _entry is None:
        lib = _build.library(SOURCE)
        _entry = (lib.flash_attention_fwd, lib.flash_attention_combine)
    return _entry


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
            "the attention kernel has no backward: call it under "
            "torch.no_grad(); training takes the differentiable form, "
            "models.attention.blockwise_attention(differentiable=True)")
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


def _fake(q, k, v) -> bool:
    """Whether q, k and v are fake tensors (all or none)."""
    from torch._subclasses.fake_tensor import FakeTensor

    fake = [isinstance(t, FakeTensor) for t in (q, k, v)]
    if any(fake) and not all(fake):
        raise ValueError("q, k and v must all be fake tensors or none")
    return fake[0]


def work(q, k, causal: bool, lens) -> tuple[int, int]:
    """(operations, bytes) the function needs for q [B, Tq, Hq, D] and k
    [B, Tkv, Hkv, D] with the B key counts ``lens``: 4 D per visible (row,
    key) pair and q head; q, k and v read once and o written once (the
    kernels line's bound)."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    # ends-aligned causal: row i sees i + n - Tq + 1 of the n keys
    pairs = sum(tq * n - (tq * (tq - 1) // 2 if causal else 0) for n in lens)
    return (4 * d * hq * pairs,
            q.element_size() * (2 * b * tq * hq * d + 2 * sum(lens) * hkv * d))


def attention(q, k, v, *, causal=True, scale=None, kv_len=None,
              kv_chunk=1024):
    """q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D] -> [B, Tq, Hq, D] in q's
    dtype. ``kv_len`` ([] or [B], default Tkv) bounds the valid keys of each
    batch row; under ``causal`` it must be at least Tq. ``kv_chunk`` is the
    plain version's chunk (the kernel tiles the keys itself). On the card
    the body is the one :func:`plan` names."""
    b, tq, hq, d = q.shape
    tkv = k.shape[1]
    lens = kv_lengths(kv_len, b, tkv)
    on_card = _check(q, k, v, causal, lens)
    if _fake(q, k, v):
        from ..distributed import cost

        cost.charge("flash_attention", *work(q, k, causal, lens))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not on_card:
        return attention_plain(q, k, v, causal=causal, scale=scale,
                               kv_len=lens, kv_chunk=kv_chunk)
    return launch(q, k, v, plan(b, tq, tkv, hq, k.shape[2], d, q.dtype, lens),
                  causal=causal, scale=scale, lens=lens)


def launch(q, k, v, pl: Plan, *, causal, scale, lens):
    """Launches body ``pl.body`` on CUDA tensors that :func:`attention`'s
    checks passed, with ``lens`` as B host ints; raises if a launch fails.
    :func:`attention` calls it with :func:`plan`'s choice."""
    b, tq, hq, d = q.shape
    tkv, hkv = k.shape[1], k.shape[2]
    if d % 8 or d > 256:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to "
                         f"256, got {d}")
    if (pl.body, q.dtype) in (("mma", torch.float32),
                              ("simt", torch.bfloat16)):
        raise ValueError(f"the {pl.body} body does not take {q.dtype}")
    _check_layout(q, k, v)
    dev = q.device
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    kvl = (None if all(n == lens[0] for n in lens)
           else torch.tensor(lens, dtype=torch.int32).to(dev))
    scratch = None
    if pl.body == "split":
        rows = tq * (hq // hkv)
        if rows > SPLIT_ROWS or pl.chunk % SPLIT_KEYS or pl.chunk < SPLIT_KEYS \
                or pl.splits * pl.chunk < max(lens):
            raise ValueError(f"no split plan {pl} for {rows} rows and "
                             f"kv_len up to {max(lens)}")
        scratch = torch.empty(b * hkv * pl.splits * rows * (d + 2),
                              dtype=torch.float32, device=dev)
    args = _Args(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kvl is None else kvl.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, tq, tkv, hq, hkv, d, lens[0], int(causal), _DTYPES[q.dtype],
        _BODIES[pl.body], pl.splits, pl.chunk,
        scale if scale is not None else 1.0 / math.sqrt(d))
    if dev.index == torch.cuda.current_device():
        _run(args, pl.body, dev)
    else:
        with torch.cuda.device(dev):
            _run(args, pl.body, dev)
    return out


def _run(args, body, dev):
    """The body's kernel, then (split body) the combine; each launch is
    counted and checked."""
    fwd, combine = _entry_points()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches["flash_attention"] += 1
    steps = [(body, fwd)] + ([("combine", combine)] if body == "split" else [])
    for name, fn in steps:
        launches[f"flash_attention_{name}"] += 1
        rc = fn(ctypes.addressof(args), stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention {name} kernel launch failed: "
                               f"CUDA error {rc}")


def flash_attention(q, k, v, *, causal=True, scale=None, kv_len=None):
    """The Pallas kernel's layout: q [B, Hq, Tq, D], k/v [B, Hkv, Tkv, D] ->
    [B, Hq, Tq, D]. Views into :func:`attention`; nothing is copied."""
    return attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=causal, scale=scale, kv_len=kv_len).transpose(1, 2)
