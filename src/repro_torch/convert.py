"""Carry graph memories and simulation states across from the reference.

The reference package's objects arrive as numpy: a ``GraphMemory``'s fields,
or a simulation state pytree with every leaf converted by ``np.asarray``.
These functions turn them into the port's objects and back, so a state can
be handed over mid-run and compared leaf for leaf.

Two representations differ:
  * RDY words (``state["sched"]["rdy"]``) are uint32 in the reference and
    int32 storage here: they are reinterpreted (``.view``), never converted;
  * a link's packet is a dict of six [nx, ny] fields in the reference and
    one [6, nx, ny] int32 tensor here (:func:`repro_torch.core.noc.pack`).

A batched state (``batched=True``) has a leading config axis on every leaf:
the reference's link fields are [B, nx, ny] and the port's links
[B, 6, nx, ny]; the members' scheduler states nest under ``sched`` as in the
reference.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .api import resolve_device
from .core import noc
from .core.partition import GraphMemory

_LINKS = ("link_e", "link_s")
_WORDS = ("rdy",)


def graph_memory_from_numpy(arrays: Mapping) -> GraphMemory:
    """The reference ``GraphMemory``'s fields, by name, as numpy values ->
    the port's :class:`GraphMemory`, with copies of the arrays."""
    return GraphMemory(**{
        f.name: int(arrays[f.name]) if f.type == "int"
        else np.array(arrays[f.name], copy=True)
        for f in dataclasses.fields(GraphMemory)})


def _to_tensor(a, device, key=None):
    a = np.array(a, copy=True)
    if key in _WORDS:
        if a.dtype != np.uint32:
            raise TypeError(f"{key} must be uint32 words, got {a.dtype}")
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree: Mapping, device=None, *,
                     batched: bool = False) -> dict:
    """Reference state pytree (numpy leaves) -> the port's state dict on
    ``device`` (``None`` = the CUDA card; raises without one). ``batched``:
    the leaves carry a leading config axis."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in _LINKS:
            packed = noc.pack({f: torch.from_numpy(np.array(v[f], copy=True))
                               for f in noc.PKT_FIELDS})
            if batched:                      # [6, B, nx, ny] -> [B, 6, nx, ny]
                packed = packed.transpose(0, 1).contiguous()
            out[k] = packed.to(device)
        elif isinstance(v, Mapping):
            out[k] = state_from_numpy(v, device, batched=batched)
        else:
            out[k] = _to_tensor(v, device, k)
    return out


def state_to_numpy(state: Mapping, *, batched: bool = False) -> dict:
    """The port's state dict -> a reference-layout pytree of numpy arrays
    (``batched``: the leaves carry a leading config axis)."""
    out = {}
    for k, v in state.items():
        if k in _LINKS:
            fields = noc.unpack(v.transpose(0, 1) if batched else v)
            out[k] = {f: t.cpu().numpy() for f, t in fields.items()}
        elif isinstance(v, Mapping):
            out[k] = state_to_numpy(v, batched=batched)
        else:
            a = v.cpu().numpy()
            out[k] = a.view(np.uint32) if k in _WORDS else a
    return out
