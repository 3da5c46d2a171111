"""Fault-tolerant checkpointing: atomic manifest-based save/restore.

The counterpart of the reference package's ``checkpoint/manager.py``, with
its layout: ``<dir>/step_<N>/manifest.json`` + ``leaf_<i>.npy`` (one file
per leaf), written to ``step_<N>.tmp`` and renamed, so a crash mid-save
never corrupts the latest checkpoint; ``LATEST`` is a one-line pointer file
replaced after the rename. An async mode hands the save to a writer thread
(the train loop continues; ``wait()`` joins before exit or the next async
save, and raises what the save raised), and ``keep_n`` keeps the newest
checkpoints.

A tree is nested dicts, lists and tuples of tensors or numpy arrays (None
holds no leaf). Its leaves are written in JAX's flatten order: a dict's
values by sorted key, a list's in order. A train state (its ``params`` an
:class:`~repro_torch.models.lm.LM`) is written as the reference's train
state, ``{"opt": {"count", "m", "master", "v"}, "params", "step"}`` with
each parameter tree in the reference's layout (segments stacked on a
leading layer axis; :func:`repro_torch.convert.train_state_tree`), so the
leaves are the reference's, in its order and shapes. So each package
restores the other's float32 checkpoints.

Where the two formats differ:
  * the manifest: the reference stores ``treedef``, JAX's string of the
    tree's structure; the port stores ``paths``, each leaf's path
    (``"opt/m/segments/0/attn/wq/w"``). Neither reads the other's: restore
    goes by the template's structure and checks the leaf count and shapes;
  * bfloat16 leaves: both write them as numpy's 2-byte void (``<V2``, the
    bit pattern) with ``"dtype": "bfloat16"`` in the manifest, which is how
    numpy saves the reference's ``ml_dtypes.bfloat16``. The port reads them
    back bit for bit, its own and the reference's. The reference's restore
    returns them as that void array, as it returns its own bfloat16 leaves
    (``.view(ml_dtypes.bfloat16)`` gives the values). The card's host has
    no ``ml_dtypes``; the port needs none.

Restore returns the template's structure with CPU tensor leaves (a train
state template: a train state on the template's device).

A sharded train state (DTensor leaves, :mod:`repro_torch.train.sharded`)
is written as the whole state: every rank gathers each leaf to a host
tensor on the calling thread (the writer thread runs no collective), and
rank 0 writes. Restored into a sharded template, each leaf is placed on
the template's mesh, whatever mesh wrote it; into a one-device template,
on its device. So a checkpoint moves between meshes and one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_BF16 = "bfloat16"


def _is_train_state(tree) -> bool:
    return isinstance(tree, Mapping) and isinstance(tree.get("params"),
                                                    nn.Module)


def _flatten_with_paths(tree, prefix=""):
    """[(path, leaf)] in JAX's order: dict values by sorted key, list and
    tuple items in order, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(tree, leaves):
    """The structure of ``tree`` with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _sharded(tree) -> bool:
    from ..train.sharded import is_sharded
    return _is_train_state(tree) and is_sharded(tree)


def _writes(tree) -> bool:
    """Whether this rank writes ``tree``: rank 0 of a sharded state's
    ranks, anyone otherwise."""
    return not (_sharded(tree) and dist.get_rank() != 0)


def _host_tree(tree):
    """The tree to write, its leaves copied to the host (the caller may go
    on updating its own in place): a train state in the reference's
    layout."""
    if _is_train_state(tree):
        from .. import convert
        return convert.train_state_tree(tree)
    return _map(lambda x: x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x, copy=True),
                tree)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_file(leaf):
    """A host leaf -> (numpy array to save, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            return bits.view(np.uint16).view("V2"), _BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save(path: str, step: int, tree) -> str:
    """Atomic synchronous save. Returns the final step directory (a
    sharded state's ranks but 0 gather and write nothing)."""
    host_tree = _host_tree(tree)
    if not _writes(tree):
        return os.path.join(path, f"step_{step:08d}")
    return _write(path, step, host_tree)


def _write(path: str, step: int, host_tree) -> str:
    """Write a tree already on the host (:func:`_host_tree`)."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(host_tree)
    manifest = {"step": step, "paths": [p for p, _ in flat],
                "num_leaves": len(flat), "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _to_file(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(path, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(path, "LATEST.tmp"), os.path.join(path, "LATEST"))
    return final


def latest_step(path: str) -> int | None:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(path: str, like, step: int | None = None):
    """Restore into the structure of ``like`` (validates leaf count and
    shapes). A train state template gives a train state on its device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    state = like if _is_train_state(like) else None
    if state is not None:
        from .. import convert
        like = convert.train_state_tree(state, device="meta")
    flat = _flatten_with_paths(like)
    if manifest["num_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"template has {len(flat)}")
    out = []
    for i, (p, tmpl) in enumerate(flat):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if hasattr(tmpl, "shape") and tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i} ({p}): shape {arr.shape} != "
                             f"template {tuple(tmpl.shape)}")
        out.append(_from_file(arr, manifest["leaves"][i]["dtype"]))
    tree = _unflatten(like, iter(out))
    if state is None:
        return tree
    model = state["params"]
    if _sharded(state):
        return convert.train_state_from_numpy(
            model.cfg, tree, device=model.embed.to_local().device,
            mesh=model.embed.device_mesh)
    return convert.train_state_from_numpy(model.cfg, tree,
                                          device=model.embed.device)


class CheckpointManager:
    def __init__(self, path: str, keep_n: int = 3, async_save: bool = True):
        self.path = path
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def wait(self):
        """Join the writer thread; raise what an async save raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, step: int, tree):
        # Pull to host before handing to the writer thread (a sharded
        # state's gathers are collectives: never in the thread).
        host_tree = _host_tree(tree)
        if not _writes(tree):
            return
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_in_thread, args=(step, host_tree),
                daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree)

    def _save_and_gc(self, step, host_tree):
        _write(self.path, step, host_tree)
        self._gc()

    def _save_in_thread(self, step, host_tree):
        try:
            self._save_and_gc(step, host_tree)
        except BaseException as e:      # raised again by wait()
            self._error = e

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.path)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like):
        return restore(self.path, like)

    def latest_step(self):
        return latest_step(self.path)
