"""Packed RDY bit-flag vectors (paper §II-B), as torch tensor ops.

Slot ``s`` of a PE maps to word ``s // 32``, bit position ``31 - s % 32`` —
slot 0 occupies the *most significant* bit of word 0, so the paper's
"leading-one detector" (find the first 1 scanning from the MSB of word 0)
returns the lowest slot index == the most critical ready node.

Storage: a word is held in ``torch.int32`` with the uint32 bit pattern of the
reference (slot 0 set makes the word negative). torch's uint32 lacks shifts,
subtraction, ``min`` and ``index_put`` on the CPU, and int32 ``>>`` is
arithmetic, so every operation that depends on the unsigned value widens to
int64, masks with ``0xFFFFFFFF`` and narrows back. ``|``, ``&``, ``~`` and
``!= 0`` act on the bit pattern and need no widening. The CUDA kernels in
:mod:`repro_torch.kernels.lod` read the same storage as ``uint32_t``.
"""
from __future__ import annotations

import torch

FLAGS_PER_WORD = 32
_LOW32 = 0xFFFFFFFF


def widen(w: torch.Tensor) -> torch.Tensor:
    """int32 word storage -> int64 holding the unsigned value in [0, 2**32)."""
    return w.to(torch.int64) & _LOW32


def narrow(u: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 storage with the same 32-bit pattern.

    The int64 -> int32 conversion keeps the low 32 bits (two's complement
    wrap) on both the CPU and CUDA."""
    return u.to(torch.int32)


def slot_word_mask(slot: torch.Tensor):
    """slot (>= 0) -> (word index int64, single-bit mask as int32 storage)."""
    slot = slot.to(torch.int64)
    return slot >> 5, narrow(0x80000000 >> (slot & 31))


def set_bit(bits, pe, slot, on):
    """Set one bit per listed PE row where ``on``. bits: [P, W]; pe/slot/on:
    [n] with distinct ``pe``. Returns a new tensor."""
    word, mask = slot_word_mask(slot)
    pe = pe.to(torch.int64)
    row = bits[pe, word]
    return bits.index_put((pe, word), torch.where(on, row | mask, row))


def smear(w):
    """Propagate the leading one to all lower bits (int32 word storage)."""
    u = widen(w)
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    return narrow(u)


def popcount(w):
    """SWAR population count of each 32-bit word -> int32."""
    u = widen(w)
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def mask_slots_ge(ptr, W: int):
    """[...] slot pointer -> [..., W] mask (int32 storage) of slots >= ptr.

    Within the pointer's word the surviving bits are positions
    0 .. 31 - ptr % 32: the rotating-priority window of the ``scan`` and
    ``lru_flat`` policies."""
    ptr = ptr.to(torch.int64)
    word_ids = torch.arange(W, dtype=torch.int64, device=ptr.device)
    pw = (ptr // FLAGS_PER_WORD)[..., None]
    pb = (ptr % FLAGS_PER_WORD)[..., None]
    eq = narrow(torch.full_like(pb, _LOW32) >> pb)
    full = torch.full_like(eq, -1)
    return torch.where(word_ids > pw, full,
                       torch.where(word_ids < pw, torch.zeros_like(eq), eq))


def lod_word(w):
    """Leading-one position inside a word: 0 == MSB; 32 for an empty word.

    Equal to the reference's ``32 - popcount(smear(w))`` for every word: the
    exponent ``frexp`` reports for the (exactly representable) float64 value
    is the word's bit length."""
    return (32 - torch.frexp(widen(w).to(torch.float64))[1]).to(torch.int32)


def leading_one(bits):
    """Hierarchical leading-one detect over packed rows.

    bits: [..., W] int32 storage. Returns the int32 slot index of the first
    set flag in (word, MSB-first-bit) order, or -1 if the row is empty. This
    is the tensor form of the OuterLOD/InnerLOD circuit pair: each word's
    leading one (InnerLOD) is keyed as ``32 * word + clz``, and the row's
    minimum key (OuterLOD) is the first set slot.
    """
    W = bits.shape[-1]
    length = torch.frexp(widen(bits).to(torch.float64))[1]  # 0 for an empty word
    # 32 * word + clz == 32 * (word + 1) - bit length; empty words key past
    # every slot.
    ends = torch.arange(FLAGS_PER_WORD, FLAGS_PER_WORD * (W + 1), FLAGS_PER_WORD,
                        dtype=torch.int32, device=bits.device)
    none = FLAGS_PER_WORD * W
    key = torch.where(length > 0, ends - length, none).amin(dim=-1)
    return torch.where(key < none, key, -1)


def rotating_leading_one(bits, ptr):
    """First set slot at or after ``ptr`` ([...]) in each row of ``bits``
    ([..., W]), wrapping to :func:`leading_one` when that window is empty:
    the rotating-priority pick of the ``scan`` and ``lru_flat`` policies."""
    hi = leading_one(bits & mask_slots_ge(ptr, bits.shape[-1]))
    return torch.where(hi >= 0, hi, leading_one(bits))


def clear_slot(bits, slot, on):
    """Copy of ``bits`` ([..., W]) with the flag of ``slot`` ([...], clamped
    into [0, 32 W)) cleared on rows where ``on``: a gather/scatter along the
    word axis, one word per row."""
    L = bits.shape[-1] * FLAGS_PER_WORD
    word, mask = slot_word_mask(slot.clamp(0, L - 1))
    row = torch.gather(bits, -1, word[..., None])[..., 0]
    new = torch.where(on, row & ~mask, row)
    return bits.scatter(-1, word[..., None], new[..., None])


def count_set(bits):
    """Total set flags per row ([..., W] -> [...])."""
    return popcount(bits).sum(dim=-1, dtype=torch.int32)
