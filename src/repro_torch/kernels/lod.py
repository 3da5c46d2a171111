"""Hierarchical leading-one detect (paper §II-B): CUDA kernels and their
plain torch versions.

The three wrappers replace the Pallas TPU kernels of the reference package's
``kernels/lod.py`` (``lod``, ``schedule_step``, ``rotating_schedule_step``).
Each takes RDY words as ``[P, W]`` int32 storage holding the uint32 bit
pattern (see :mod:`repro_torch.core.bitvec`):

  * a tensor on the CPU goes to the plain version (``*_plain``): the
    policies' pick and clear from :mod:`repro_torch.core.bitvec`, which the
    ``"tensor"`` engine runs too;
  * a CUDA tensor launches the kernel of ``csrc/lod.cu`` on the current
    stream, or raises. There is no fallback.

:data:`launches` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels. On the card the engines replay each
K-cycle chunk from a captured CUDA graph
(:class:`repro_torch.core.overlay.ReplayedChunk`), which adds the launches
its capture recorded at every replay.
"""
from __future__ import annotations

import torch

from ..core import bitvec
from . import _build

SOURCE = "lod.cu"

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches: dict[str, int] = {
    "lod": 0, "schedule_step": 0, "rotating_schedule_step": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: the scheduler policies' own pick and clear
# (:mod:`repro_torch.core.bitvec`), which the ``"tensor"`` engine runs.
# ---------------------------------------------------------------------------

def _do(slot, gate):
    have = slot >= 0
    return have if gate is None else have & (gate != 0)


def lod_plain(bits):
    """[P, W] -> [P] int32 first set slot, -1 for an empty row."""
    return bitvec.leading_one(bits)


def schedule_step_plain(bits, gate=None):
    """Pick as :func:`lod_plain`, then clear the pick on rows where ``gate``
    (every row when None). -> (slot [P] int32, new bits [P, W])."""
    slot = bitvec.leading_one(bits)
    return slot, bitvec.clear_slot(bits, slot, _do(slot, gate))


def rotating_schedule_step_plain(bits, ptr, gate=None):
    """First set slot at or after ``ptr`` per row, wrapping to the plain pick
    when that window is empty; gated clear as :func:`schedule_step_plain`."""
    slot = bitvec.rotating_leading_one(bits, ptr)
    return slot, bitvec.clear_slot(bits, slot, _do(slot, gate))


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check(bits, ptr=None, gate=None):
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(
            f"bits must be a contiguous [P, W] int32 tensor, got "
            f"{tuple(bits.shape)} {bits.dtype}")
    p = bits.shape[0]
    for name, t, dtype in (("ptr", ptr, torch.int32), ("gate", gate, torch.bool)):
        if t is None:
            continue
        if t.dtype != dtype or t.shape != (p,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous [{p}] {dtype} tensor, got "
                f"{tuple(t.shape)} {t.dtype}")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on {bits.device}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no leading-one kernel for device {bits.device}")
    return bits.device.type == "cuda"


def _launch(name, fn, *args):
    launches[name] += 1
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def lod(bits):
    """[P, W] RDY words -> [P] int32 leading ready slot (or -1)."""
    if not _check(bits):
        return lod_plain(bits)
    p, w = bits.shape
    slot = torch.empty(p, dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        _launch("lod", _build.library(SOURCE).lod_pick,
                bits.data_ptr(), slot.data_ptr(), p, w)
    return slot


def schedule_step(bits, gate=None):
    """Fused pick + gated clear: [P, W] -> (slot [P] int32, new bits [P, W]).

    ``gate`` ([P] bool, default all on) restricts the clear to gated rows;
    ungated rows still report their pick but keep the bit set."""
    if not _check(bits, gate=gate):
        return schedule_step_plain(bits, gate)
    p, w = bits.shape
    slot = torch.empty(p, dtype=torch.int32, device=bits.device)
    new_bits = torch.empty_like(bits)
    with torch.cuda.device(bits.device):
        _launch("schedule_step", _build.library(SOURCE).lod_schedule_step,
                bits.data_ptr(), _ptr(gate), slot.data_ptr(),
                new_bits.data_ptr(), p, w)
    return slot, new_bits


def rotating_schedule_step(bits, ptr, gate=None):
    """Rotating-pointer pick + gated clear for ``scan``/``lru_flat``: first
    ready slot at/after ``ptr`` (wrapping), cleared where ``gate``.
    [P, W] bits, [P] int32 ptr -> (slot [P] int32, new bits [P, W])."""
    if not _check(bits, ptr=ptr, gate=gate):
        return rotating_schedule_step_plain(bits, ptr, gate)
    p, w = bits.shape
    slot = torch.empty(p, dtype=torch.int32, device=bits.device)
    new_bits = torch.empty_like(bits)
    with torch.cuda.device(bits.device):
        _launch("rotating_schedule_step",
                _build.library(SOURCE).lod_rotating_schedule_step,
                bits.data_ptr(), ptr.data_ptr(), _ptr(gate), slot.data_ptr(),
                new_bits.data_ptr(), p, w)
    return slot, new_bits
