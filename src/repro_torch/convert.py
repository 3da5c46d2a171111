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


def state_from_numpy(tree: Mapping, device=None) -> dict:
    """Reference state pytree (numpy leaves) -> the port's state dict on
    ``device`` (``None`` = the CUDA card; raises without one)."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in _LINKS:
            out[k] = noc.pack({f: torch.from_numpy(np.array(v[f], copy=True))
                               for f in noc.PKT_FIELDS}).to(device)
        elif isinstance(v, Mapping):
            out[k] = state_from_numpy(v, device)
        else:
            out[k] = _to_tensor(v, device, k)
    return out


def state_to_numpy(state: Mapping) -> dict:
    """The port's state dict -> a reference-layout pytree of numpy arrays."""
    out = {}
    for k, v in state.items():
        if k in _LINKS:
            out[k] = {f: t.cpu().numpy() for f, t in noc.unpack(v).items()}
        elif isinstance(v, Mapping):
            out[k] = state_to_numpy(v)
        else:
            a = v.cpu().numpy()
            out[k] = a.view(np.uint32) if k in _WORDS else a
    return out
