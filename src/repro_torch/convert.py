"""Carry graph memories, simulation states and LM weights across from the
reference.

The reference package's objects arrive as numpy: a ``GraphMemory``'s fields,
a simulation state pytree or an LM parameter pytree with every leaf
converted by ``np.asarray``. These functions turn them into the port's
objects (and states back), so a state can be handed over mid-run and
compared leaf for leaf, and both packages can run the same weights.

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

import collections
import dataclasses
import os
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .api import resolve_device
from .core import noc
from .core.partition import GraphMemory
from .models import lm, ssm

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


# ---------------------------------------------------------------------------
# LM weights.
# ---------------------------------------------------------------------------

def _lm_leaf_specs(cfg):
    """(path, shape, init) of every leaf of the reference's LM parameter
    tree (``repro.models.lm.init``), in a fixed order. A segment's leaves
    carry a leading [n] layer axis; the hybrid's shared block
    (``("shared_attn", ...)``) has none, and its segments hold no leaves.
    An encoder-decoder's come last: ``("encoder", "blocks", ...)`` stacked
    on ``[enc_layers]``, ``("encoder", "final_norm", ...)``, and
    ``("cross_attn", ...)`` (``ln`` and ``attn``) stacked on
    ``[num_layers]``.
    ``init`` is ``"embed"`` (normal x 0.02), ``"dense"`` (normal /
    sqrt(fan_in), the fan-in the unstacked leaf's first axis), ``"conv"``
    (normal x 0.5, the Mamba2 conv's fixed scale), ``"a_log"``
    (log(1..nheads)), ``"dt_bias"`` (the inverse softplus of exp(U(log 1e-3,
    log 1e-1))), ``"ones"`` or ``"zeros"``."""
    d, vocab = cfg.d_model, cfg.padded_vocab
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    out = [(("embed",), (vocab, d), "embed")]

    def norm(pre, lead=(), width=d):
        out.append((pre + ("w",), (*lead, width), "ones"))
        if cfg.norm == "layernorm" and pre[-1] != "kv_norm":
            out.append((pre + ("b",), (*lead, width), "zeros"))

    def leaf_fns(pre, lead):
        def leaf(name, *shape, init="dense"):
            out.append((pre + name, (*lead, *shape), init))

        def dense(name, *shape, bias=False, leaf_name=("w",)):
            leaf(name + leaf_name, *shape)
            if bias:
                leaf(name + ("b",), shape[-1], init="zeros")

        return leaf, dense

    def attention(dense):
        hd = cfg.hd
        dense(("attn", "wq"), d, h * hd, bias=cfg.qkv_bias)
        dense(("attn", "wk"), d, hkv * hd, bias=cfg.qkv_bias)
        dense(("attn", "wv"), d, hkv * hd, bias=cfg.qkv_bias)
        dense(("attn", "wo"), h * hd, d, bias=cfg.proj_bias)

    def block(pre, lead, kind):
        leaf, dense = leaf_fns(pre, lead)
        norm(pre + ("ln1",), lead)
        if kind == "mamba":
            s = cfg.ssm
            d_inner, nheads, conv_dim = ssm.dims(cfg)
            dense(("mamba", "in_proj"), d, 2 * d_inner + 2 * s.d_state + nheads)
            leaf(("mamba", "conv", "w"), s.d_conv, conv_dim, init="conv")
            leaf(("mamba", "conv", "b"), conv_dim, init="zeros")
            leaf(("mamba", "A_log"), nheads, init="a_log")
            leaf(("mamba", "D"), nheads, init="ones")
            leaf(("mamba", "dt_bias"), nheads, init="dt_bias")
            leaf(("mamba", "norm", "w"), d_inner, init="ones")
            dense(("mamba", "out_proj"), d_inner, d)
            return
        if cfg.mla is not None:
            m = cfg.mla
            dense(("attn", "wq"), d, h * (m.nope_head_dim + m.rope_head_dim))
            dense(("attn", "w_dkv"), d, m.kv_lora_rank + m.rope_head_dim)
            norm(pre + ("attn", "kv_norm"), lead, m.kv_lora_rank)
            dense(("attn", "w_uk"), m.kv_lora_rank, h * m.nope_head_dim)
            dense(("attn", "w_uv"), m.kv_lora_rank, h * m.v_head_dim)
            dense(("attn", "wo"), h * m.v_head_dim, d)
        else:
            attention(dense)
        norm(pre + ("ln2",), lead)
        if kind == "moe":
            m = cfg.moe
            e, fe = m.num_experts, m.d_ff_expert
            dense(("ffn", "router"), d, e)
            dense(("ffn", "w_gate"), e, d, fe, leaf_name=())
            dense(("ffn", "w_up"), e, d, fe, leaf_name=())
            dense(("ffn", "w_down"), e, fe, d, leaf_name=())
            if m.num_shared:
                fs = m.num_shared * fe
                dense(("ffn", "shared", "w_gate"), d, fs)
                dense(("ffn", "shared", "w_up"), d, fs)
                dense(("ffn", "shared", "w_down"), fs, d)
        elif cfg.mlp_glu:
            dense(("ffn", "w_gate"), d, f)
            dense(("ffn", "w_up"), d, f)
            dense(("ffn", "w_down"), f, d)
        else:
            dense(("ffn", "w_up"), d, f, bias=cfg.proj_bias)
            dense(("ffn", "w_down"), f, d, bias=cfg.proj_bias)

    shared_made = False
    for si, (kind, n) in enumerate(lm.segments(cfg)):
        if kind == "shared_attn":
            if not shared_made:
                block(("shared_attn",), (), "attn")
                shared_made = True
            continue
        block(("segments", si), (n,), kind)
    norm(("final_norm",))
    if not cfg.tie_embeddings:
        out.append((("lm_head",), (d, vocab), "embed"))
    if cfg.encdec is not None:
        block(("encoder", "blocks"), (cfg.encdec.enc_layers,), "attn")
        norm(("encoder", "final_norm"))
        lead = (cfg.num_layers,)
        norm(("cross_attn", "ln"), lead)
        attention(leaf_fns(("cross_attn",), lead)[1])
    return out


def _stacked(path) -> bool:
    """Whether a leaf of the reference's tree carries a leading layer axis:
    a segment's, the encoder's blocks' and the cross-attention's."""
    return (path[0] in ("segments", "cross_attn")
            or tuple(path[:2]) == ("encoder", "blocks"))


def _draw_leaf(i: int, path, shape, init: str, seed: int) -> np.ndarray:
    """Leaf ``i`` of the recipe (:func:`numpy_lm_leaves`)."""
    if init in ("ones", "zeros"):
        return np.full(shape, init == "ones", dtype=np.float32)
    if init == "a_log":
        return np.broadcast_to(np.log(np.arange(
            1, shape[-1] + 1, dtype=np.float32)), shape).copy()
    rng = np.random.default_rng([seed, i])
    if init == "dt_bias":
        lo, hi = np.log(np.float32(1e-3)), np.log(np.float32(1e-1))
        dt = np.exp(rng.random(shape, dtype=np.float32) * (hi - lo) + lo)
        return dt + np.log(-np.expm1(-dt))
    scale = {"embed": 0.02, "conv": 0.5}.get(init)
    if scale is None:
        scale = 1.0 / np.sqrt(shape[1] if _stacked(path) else shape[0])
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= np.float32(scale)
    return x


def numpy_lm_leaves(cfg, seed: int = 0, *, threads: int = 1):
    """Yield (path, float32 array) for every leaf of :func:`numpy_lm_params`,
    in the recipe's order. Leaf ``i`` draws from ``np.random.default_rng([seed,
    i])``, so each leaf can be made without the others. A ``"dense"`` leaf
    is scaled by 1/sqrt(fan-in), the fan-in being the first axis of the
    leaf without its layer axis, as the reference's ``dense_init`` takes
    ``shape[0]``: ``d_in`` of a matrix ``[n, d_in, d_out]``, but ``E`` (the
    expert count) of the stacked expert weights ``[n, E, d, f]``, not
    ``d``. ``threads`` leaves are drawn at once, in threads (numpy's
    generators release the interpreter lock while they fill an array), so
    at most ``threads`` leaves are held beyond the one yielded; the default
    draws one at a time."""
    with ThreadPoolExecutor(threads) as pool:
        pending = collections.deque()
        for i, (path, shape, init) in enumerate(_lm_leaf_specs(cfg)):
            pending.append((path, pool.submit(_draw_leaf, i, path, shape,
                                              init, seed)))
            if len(pending) == threads:
                done, leaf = pending.popleft()
                yield done, leaf.result()
        for done, leaf in pending:
            yield done, leaf.result()


def numpy_lm_params(cfg, seed: int = 0) -> dict:
    """The reference's LM parameter tree for ``cfg`` (the shapes of
    ``repro.models.lm.init``, its initialisers' scales and constants), drawn
    with numpy from ``seed``, every leaf float32; ``None`` at each
    ``"shared_attn"`` segment, as the reference's tree. Both packages can
    then be fed the same weights, at any width. The leaves are those of
    :func:`numpy_lm_leaves`, drawn up to 8 at a time."""
    return _tree_of(cfg, numpy_lm_leaves(
        cfg, seed, threads=min(8, os.cpu_count() or 1)))


def _tree_of(cfg, leaves) -> dict:
    """The reference-layout LM tree of the (path, leaf) pairs ``leaves``
    (paths of :func:`_lm_leaf_specs`); ``None`` at each ``"shared_attn"``
    segment, as the reference's tree."""
    tree: dict = {"segments": [None] * len(lm.segments(cfg))}
    for path, x in leaves:
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                if node[key] is None:
                    node[key] = {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = x
    return tree


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _named_leaves(cfg, tree: Mapping):
    """(port parameter name, leaf) for every leaf of a reference-layout LM
    tree: each segment split into its layers (``blocks.{i}.*``), an
    encoder-decoder's ``encoder.blocks`` and ``cross_attn`` leaves split the
    same way (``encoder.blocks.{j}.*``, ``cross_attn.{j}.*``), every other
    leaf under its dotted path. A ``"shared_attn"`` segment holds ``None``
    (its layers run the one ``shared_attn`` block, under the tree's
    ``shared_attn``). Checks each stacked leaf's layer count."""
    def layers(prefix, stacked, n, first=0):
        for name, leaf in _flatten(stacked):
            if np.shape(leaf)[0] != n:
                raise ValueError(f"{prefix} leaf {name} has "
                                 f"{np.shape(leaf)[0]} layers, want {n}")
            for j in range(n):
                yield f"{prefix}.{first + j}.{name}", leaf[j]

    for key, value in tree.items():
        if key == "segments":
            continue
        if key == "cross_attn" and cfg.encdec is not None:
            yield from layers("cross_attn", value, cfg.num_layers)
        elif key == "encoder" and cfg.encdec is not None:
            for sub, part in value.items():
                if sub == "blocks":
                    yield from layers("encoder.blocks", part,
                                      cfg.encdec.enc_layers)
                else:
                    yield from _flatten(part, f"encoder.{sub}.")
        elif isinstance(value, Mapping):
            yield from _flatten(value, f"{key}.")
        else:
            yield key, value
    layer = 0
    for (kind, n), seg in zip(lm.segments(cfg), tree["segments"],
                              strict=True):
        if kind == "shared_attn":
            if seg:
                raise ValueError("a shared_attn segment holds no leaves (the "
                                 "shared block's are under shared_attn)")
        else:
            yield from layers("blocks", seg, n, layer)
        layer += n


def _leaf(x) -> torch.Tensor:
    """A numpy array or a tensor -> a tensor (numpy copied)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def _load(named: dict, cfg, leaves, what: str) -> None:
    """Copy each leaf of the (port name, leaf) pairs ``leaves`` into the
    tensor of its name in ``named``, cast to that tensor's dtype; every
    leaf must land on exactly one tensor and every tensor must be given."""
    given = set()
    for name, leaf in leaves:
        if name not in named or name in given:
            raise ValueError(f"leaf {name} has no {what} of {cfg.name}")
        t = _leaf(leaf).float()     # a float64 leaf rounds to f32 first
        if tuple(t.shape) != tuple(named[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, {what} "
                             f"{tuple(named[name].shape)}")
        named[name].copy_(t)
        given.add(name)
    missing = set(named) - given
    if missing:
        raise ValueError(f"no leaf for {what}s {sorted(missing)}")


def lm_params_from_numpy(cfg, tree: Mapping, device=None) -> "lm.LM":
    """The reference's LM parameter pytree (numpy leaves; a segment's leaves
    stacked on a leading [n] layer axis) -> the port's :class:`LM` in
    ``cfg``'s dtype on ``device`` (``None`` = the CUDA card; raises without
    one), frozen; a MoE router and Mamba2's ``A_log``, ``D`` and ``dt_bias``
    stay float32, as in the reference (each leaf is copied into its
    parameter's dtype, so routing and the SSM decays see the weights as
    drawn). Each stacked leaf is split into its layers
    (:func:`_named_leaves`). Every matrix keeps the reference's ``[in,
    out]`` orientation. Every leaf must land on exactly one parameter and
    every parameter must be given."""
    model = lm.LM(cfg, device=resolve_device(device))
    with torch.no_grad():
        _load(dict(model.named_parameters()), cfg,
              _named_leaves(cfg, tree), "parameter")
    return model


def lm_params_from_recipe(cfg, seed: int = 0, device=None,
                          threads: int = 1) -> "lm.LM":
    """:func:`lm_params_from_numpy` of ``numpy_lm_params(cfg, seed)``
    without the tree: each leaf of :func:`numpy_lm_leaves` (``threads``
    drawn at a time) is copied into its parameters as it is drawn, so the
    host holds at most ``threads`` + 1 leaves."""
    model = lm.LM(cfg, device=resolve_device(device))
    with torch.no_grad():
        _load(dict(model.named_parameters()), cfg,
              _recipe_leaves(cfg, seed, threads), "parameter")
    return model


def _recipe_leaves(cfg, seed, threads):
    """(port parameter name, leaf) for every leaf of
    :func:`numpy_lm_leaves`, a stacked leaf split into its layers; checks
    each stacked leaf's layer count."""
    names = dict(_leaf_names(cfg))
    for path, x in numpy_lm_leaves(cfg, seed, threads=threads):
        parts = list(x) if _stacked(path) else [x]
        if len(parts) != len(names[path]):
            raise ValueError(f"{path}: {len(parts)} layers, want "
                             f"{len(names[path])}")
        yield from zip(names[path], parts)


def _leaf_names(cfg):
    """(reference path, port names) of every leaf of the reference's LM
    tree, in :func:`_lm_leaf_specs`'s order: one name for an unstacked leaf,
    one a layer (in layer order) for a stacked one."""
    first, layer = {}, 0
    for si, (_, n) in enumerate(lm.segments(cfg)):
        first[si] = (layer, n)
        layer += n
    for path, _, _ in _lm_leaf_specs(cfg):
        rest = ".".join(str(p) for p in path[2:])
        if path[0] == "segments":
            l0, n = first[path[1]]
            yield path, [f"blocks.{l0 + j}.{rest}" for j in range(n)]
        elif tuple(path[:2]) == ("encoder", "blocks"):
            yield path, [f"encoder.blocks.{j}.{rest}"
                         for j in range(cfg.encdec.enc_layers)]
        elif path[0] == "cross_attn":
            rest = ".".join(path[1:])
            yield path, [f"cross_attn.{j}.{rest}"
                         for j in range(cfg.num_layers)]
        else:
            yield path, [".".join(path)]


def _reference_tree(cfg, named: Mapping, leaf) -> dict:
    """The reference-layout tree of the tensors ``named`` (by port name):
    ``leaf(tensors, stacked)`` makes each leaf from its layers' tensors."""
    return _tree_of(cfg, ((path, leaf([named[n] for n in names],
                                      _stacked(path)))
                          for path, names in _leaf_names(cfg)))


def _whole(t, device):
    """A DTensor's whole tensor (gathered: every rank of its mesh calls;
    on ``"meta"`` only its shape and dtype), any other tensor as it is."""
    from .distributed.sharding import full_tensor, is_sharded

    if not is_sharded(t):
        return t
    if torch.device(device).type == "meta":
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return full_tensor(t)


def _host(tensors, stacked, device="cpu"):
    """A leaf from its layers' tensors (DTensors gathered), copied to
    ``device`` (a copy even where they lie there already: the train step
    updates them in place)."""
    if stacked:
        return torch.stack([_whole(t, device).detach().to(device)
                            for t in tensors])
    return _whole(tensors[0], device).detach().to(device, copy=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: such a leaf comes back as its exact float32.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def named_to_numpy(cfg, named: Mapping) -> dict:
    """Tensors by the port's parameter names (the parameters, their
    gradients, the optimizer's moments) -> the reference's LM tree of numpy
    arrays: a segment's leaves stacked on a leading [n] layer axis,
    bfloat16 as its exact float32 values."""
    return _map_tree(_to_numpy, _reference_tree(cfg, named, _host))


def lm_params_to_numpy(model: "lm.LM") -> dict:
    """The port's :class:`LM` -> the reference's LM parameter tree: the
    inverse of :func:`lm_params_from_numpy` (:func:`named_to_numpy`)."""
    return named_to_numpy(model.cfg, dict(model.named_parameters()))


def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


# ---------------------------------------------------------------------------
# Train states.
# ---------------------------------------------------------------------------

def train_state_tree(state: Mapping, device="cpu") -> dict:
    """A train state (:func:`repro_torch.train.steps.init_train_state`) ->
    the reference's train-state tree with tensor leaves on ``device``:
    ``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/master/...`` (with
    master weights), ``opt/count`` and ``step``, each parameter-shaped tree
    in the reference's layout (stacked segments), dtypes kept.
    ``device="meta"`` gives the shapes and dtypes without copying. A
    sharded train state's leaves are gathered one at a time, in the tree's
    order: every rank of its mesh calls this."""
    model = state["params"]
    cfg = model.cfg

    def tree(named):
        return _reference_tree(cfg, named, lambda ts, st: _host(ts, st,
                                                                 device))

    opt = state["opt"]
    out_opt = {k: tree(opt[k]) for k in ("m", "v", "master") if k in opt}
    out_opt["count"] = _host([opt["count"]], False, device)
    return {"params": tree(dict(model.named_parameters())), "opt": out_opt,
            "step": _host([state["step"]], False, device)}


def train_state_to_numpy(state: Mapping) -> dict:
    """A train state -> the reference's train-state tree with numpy leaves
    (:func:`train_state_tree`; bfloat16 weights as their exact float32
    values; a sharded state gathered), to compare whole states with the
    reference's."""
    return _map_tree(_to_numpy, train_state_tree(state))


def train_state_from_numpy(cfg, tree: Mapping, device=None, *,
                           mesh=None) -> dict:
    """The reference's train state (``{"params", "opt": {"m", "v",
    ["master"], "count"}, "step"}``, numpy or tensor leaves, each
    parameter-shaped tree in the reference's layout) -> the port's train
    state on ``device`` (``None`` = the CUDA card; raises without one): a
    trainable :class:`LM` in ``cfg``'s dtypes, the moments and master
    weights float32 by parameter name, ``count`` and ``step`` int32
    scalars. Every leaf must land on exactly one tensor. With ``mesh`` (a
    ``DeviceMesh`` of ``device``'s type) the state is placed straight onto
    it by ``state_specs``, each rank copying only its blocks
    (:func:`repro_torch.train.sharded.train_state_from_numpy`)."""
    device = resolve_device(device)
    if mesh is not None:
        from .train import sharded
        return sharded.train_state_from_numpy(cfg, tree, mesh, device)
    model = lm_params_from_numpy(cfg, tree["params"], device=device)
    model.requires_grad_(True)
    names = dict(model.named_parameters())
    opt = {}
    with torch.no_grad():
        for key in ("m", "v", "master"):
            if key not in tree["opt"]:
                continue
            opt[key] = {n: torch.empty(p.shape, dtype=torch.float32,
                                       device=device)
                        for n, p in names.items()}
            _load(opt[key], cfg, _named_leaves(cfg, tree["opt"][key]),
                  f"opt/{key} tensor")

    def scalar(x):
        return _leaf(x).to(device=device, dtype=torch.int32).reshape(())

    opt["count"] = scalar(tree["opt"]["count"])
    return {"params": model, "opt": opt, "step": scalar(tree["step"])}
