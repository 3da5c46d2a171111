"""Sharded training over a ``("data", "model")`` mesh: the counterpart of
the reference's ``jax.jit(make_train_step(...), in_shardings=...,
out_shardings=...)`` over a train state placed by ``state_specs``.

A sharded train state is the train state's structure with every tensor a
DTensor placed by :func:`repro_torch.distributed.sharding.state_specs`:
``params`` an :class:`~repro_torch.models.lm.LM` whose parameters are
DTensors, ``opt`` ``{"m", "v", "master": {name: DTensor}, "count"}`` and
``step``, ``count`` and ``step`` replicated. Every rank of the mesh calls
these functions with the same arguments, in the same order.

The step (:func:`make_sharded_train_step`) gathers every parameter to a
whole tensor into one full-size model on the rank (no tensor-parallel
compute yet), runs the port's forward, loss and backward on the rank's
rows of the global batch (:func:`batch_rows`), sums the gradients over the
data ranks (ranks along ``"model"`` hold the same rows and the same
gradients) in their own dtype, one buffer a dtype (a bfloat16 model's are
bfloat16, as its backward gives them; float32 where microbatches
accumulate), takes the global norm over the whole gradient, and updates
only the rank's blocks of ``m``, ``v``, ``master`` and the parameters.

It computes what the one-device step computes on the global batch, up to
the order of the sums (and, in a bfloat16 model, the rounding of the
gradients' sum over the ranks):

  * the loss's sums (nll, z-loss, mask, correct) are summed over the data
    ranks before they are divided, and each rank's backward is of its own
    sums over the global denominator;
  * the MoE load-balance term ``E * sum(me * ce)`` takes ``me`` and ``ce``
    averaged over the data ranks (:func:`repro_torch.models.moe.record_balance`);
    each rank's backward is of its ``me`` against the global ``ce``, over
    the data ranks' count. Routing and drops are per sequence, so rows do
    not change them; ``moe_dropped`` is summed;
  * with ``grad_accum > 1`` microbatch i is the global batch's rows ``[i
    B / ga, (i + 1) B / ga)``, as the reference cuts it: a rank holds its
    data block of each microbatch (:func:`batch_rows`).

With one data rank the step is the one-device step's arithmetic, bit for
bit.

Serving (:func:`make_sharded_prefill_step`, :func:`make_sharded_decode_step`)
is gather-then-compute too: the counterparts of the reference's prefill and
greedy ``serve_step`` jitted over ``param_specs``, ``batch_specs`` and
``cache_specs``. Parameters placed by :func:`shard_params`, a cache by
:func:`init_cache` (the sequence over the data axes with ``seq_shard``, as
the reference places a batch of one) and the rank's rows of the batch
(:func:`serve_rows`); each step gathers the whole model, the cache's rows
of the rank whole along every other dim, runs the one-device step and
writes back the rank's own cache blocks. With one data rank its logits and
cache are the one-device step's, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..distributed import sharding
from ..models import lm, moe
from ..optim.adamw import global_norm, same_memory
from .losses import chunked_xent_sums, xent_from_sums
from .steps import _grads, forward_hidden, microbatches


def is_sharded(state) -> bool:
    """Whether a train state's parameters are DTensors."""
    return sharding.is_sharded(next(state["params"].parameters()))


def _set_param(model: nn.Module, name: str, t) -> None:
    prefix, _, leaf = name.rpartition(".")
    mod = model.get_submodule(prefix) if prefix else model
    setattr(mod, leaf, nn.Parameter(t, requires_grad=False))


def _sharded_lm(cfg, tensors: dict) -> "lm.LM":
    """An :class:`LM` whose parameters are the DTensors ``tensors`` (by
    name; every parameter given)."""
    model = lm.LM(cfg, device="meta")
    names = {n for n, _ in model.named_parameters()}
    if names != set(tensors):
        raise ValueError(f"parameters {sorted(names ^ set(tensors))[:4]} "
                         f"given or missing")
    for n, t in tensors.items():
        _set_param(model, n, t)
    return model


def init_train_state(generator: torch.Generator, cfg, optimizer,
                     mesh) -> dict:
    """The sharded train state of :func:`repro_torch.train.steps.init_train_state`:
    the whole model drawn on ``generator`` as on one device (every rank
    alike), each rank keeping its parameter blocks, and the optimizer's
    state made from the blocks alone."""
    model = lm.init(generator, cfg)
    shards = sharding.to_shardings(mesh, sharding.param_specs(cfg, model,
                                                              mesh))
    shapes = {n: p.shape for n, p in model.named_parameters()}
    blocks = {n: sharding.local_block(p.detach(), shards[n]).clone()
              for n, p in model.named_parameters()}
    del model
    opt = optimizer.init(blocks)
    scalar = sharding.to_shardings(mesh, sharding.P())

    def wrap(tensors):
        return {n: sharding.from_local(t, shards[n], shapes[n])
                for n, t in tensors.items()}

    opt = {k: sharding.from_local(v, scalar, ()) if k == "count" else wrap(v)
           for k, v in opt.items()}
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return {"params": _sharded_lm(cfg, wrap(blocks)), "opt": opt,
            "step": sharding.from_local(step, scalar, ())}


def train_state_from_numpy(cfg, tree, mesh, device) -> dict:
    """The reference's train state (numpy leaves, its layout) placed
    straight onto ``mesh``: each rank copies only its blocks to ``device``
    (parameters in their dtypes, a float64 leaf rounded to float32 first,
    as :func:`repro_torch.convert.train_state_from_numpy` loads them)."""
    from ..convert import _leaf, _named_leaves

    device = torch.device(device)
    meta = lm.LM(cfg, device="meta")
    dtypes = {n: p.dtype for n, p in meta.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    specs = sharding.param_specs(cfg, meta, mesh)
    shards = sharding.to_shardings(mesh, specs)

    def put(params_tree, dtype=None):
        out = {}
        for name, leaf in _named_leaves(cfg, params_tree):
            if name not in shapes or name in out:
                raise ValueError(f"leaf {name} has no parameter of "
                                 f"{cfg.name}")
            t = _leaf(leaf)
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"parameter {shapes[name]}")
            block = sharding.local_block(t, shards[name]).float().to(
                device=device, dtype=dtype or dtypes[name], copy=True)
            out[name] = sharding.from_local(block.contiguous(), shards[name],
                                            shapes[name])
        if set(out) != set(shapes):
            raise ValueError(f"no leaf for {sorted(set(shapes) - set(out))}")
        return out

    def scalar(x):
        t = _leaf(x).to(device=device, dtype=torch.int32).reshape(())
        return sharding.from_local(t.clone(), sharding.to_shardings(
            mesh, sharding.P()), ())

    opt = {k: put(tree["opt"][k], torch.float32)
           for k in ("m", "v", "master") if k in tree["opt"]}
    opt["count"] = scalar(tree["opt"]["count"])
    return {"params": _sharded_lm(cfg, put(tree["params"])), "opt": opt,
            "step": scalar(tree["step"])}


def batch_rows(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of the global batch ``batch`` (numpy arrays or
    tensors, rows first): its data block of each of the ``grad_accum``
    microbatches, in microbatch order (with one microbatch, the block
    ``[r B / D, (r + 1) B / D)`` of data rank r of D). Ranks along
    ``"model"`` get the same rows."""
    r, n = sharding.data_index(mesh)
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % (n * grad_accum):
            raise ValueError(f"the global batch's {b} rows of {k!r} do not "
                             f"split into {grad_accum} microbatches over "
                             f"{n} data ranks")
        per = b // grad_accum // n
        rows = x.reshape(grad_accum, b // grad_accum, *x.shape[1:])
        rows = rows[:, r * per:(r + 1) * per].reshape(grad_accum * per,
                                                       *x.shape[1:])
        out[k] = (np.ascontiguousarray(rows) if isinstance(rows, np.ndarray)
                  else rows.contiguous())
    return out


def _of(t) -> sharding.Sharding:
    return sharding.Sharding(t.device_mesh, None, tuple(t.placements))


def _buffers(leaves, dtype=None):
    """Zeroed gradient storage for ``leaves``: one flat buffer a dtype (each
    leaf's own, or ``dtype``) and a view of it a leaf, in order."""
    dtypes = [dtype or p.dtype for p in leaves]
    flats = {dt: torch.zeros(sum(p.numel() for p, d in zip(leaves, dtypes)
                                 if d == dt), dtype=dt,
                             device=leaves[0].device)
             for dt in dict.fromkeys(dtypes)}
    at = dict.fromkeys(flats, 0)
    views = []
    for p, dt in zip(leaves, dtypes):
        views.append(flats[dt][at[dt]:at[dt] + p.numel()].view(p.shape))
        at[dt] += p.numel()
    return list(flats.values()), views


def make_sharded_train_step(cfg, optimizer, mesh, *, grad_accum: int = 1,
                            moe_aux_coef: float = 0.01, z_loss: float = 0.0):
    """train_step(state, rows) -> (state, metrics) on a sharded train
    state, updated in place; ``rows`` this rank's rows of the global batch
    (:func:`batch_rows` with the same ``grad_accum``) on the state's
    device. The metrics are the global batch's, the same on every rank:
    those of :func:`repro_torch.train.steps.make_train_step`."""
    _, ndata = sharding.data_index(mesh)
    full_model = []            # the rank's whole model, made at first use

    def reduce(t):
        return sharding.reduce_data(t, mesh)

    def micro(model, rows):
        """(the rank's share of the global loss, to differentiate; the
        global total loss; the global metrics)."""
        with moe.record_balance() as balance:
            h, fm, head = forward_hidden(model, cfg, rows)
        sums = chunked_xent_sums(h, head, rows["labels"], rows.get("mask"),
                                 chunk=cfg.loss_chunk, z_loss=z_loss,
                                 valid_vocab=cfg.vocab_size)
        parts = [torch.stack([s.detach() for s in sums])]
        if fm:
            parts.append(fm["moe_dropped"].detach().reshape(1))
        parts += [x.detach() for pair in balance for x in pair]
        glob = reduce(torch.cat(parts))
        loss, metrics = xent_from_sums(*glob[:4])
        denom = metrics["tokens"]
        share = sums[0] / denom + sums[1] / denom
        total = loss
        if fm:
            if ndata == 1:
                aux = share_aux = fm["moe_aux"]
            else:
                aux = share_aux = torch.zeros_like(loss)
                at = 5
                for me, _ in balance:
                    e = me.shape[0]
                    me_g = glob[at:at + e] / ndata
                    ce_g = glob[at + e:at + 2 * e] / ndata
                    at += 2 * e
                    aux = aux + e * torch.sum(me_g * ce_g)
                    share_aux = share_aux + e * torch.sum(me * ce_g)
                share_aux = share_aux / ndata
            share = share + moe_aux_coef * share_aux
            total = total + moe_aux_coef * aux
            metrics.update(moe_aux=aux.detach(), moe_dropped=glob[4])
        return share, total.detach(), metrics

    def train_step(state, rows):
        sharded = dict(state["params"].named_parameters())
        if not full_model:
            device = next(iter(sharded.values())).to_local().device
            full_model.append(lm.LM(cfg, device=device).requires_grad_(True))
        model = full_model[0]
        full = dict(model.named_parameters())
        with torch.no_grad():
            for p, whole in zip(full.values(), sharding.full_tensors(
                    [sharded[n] for n in full])):
                p.copy_(whole)
        names, leaves = list(full), list(full.values())
        # The gradients are views of one buffer a dtype (the parameters'
        # with one microbatch, else float32), each reduced at once.
        buffers, grads = _buffers(
            leaves, None if grad_accum == 1 else torch.float32)
        if grad_accum == 1:
            share, loss, metrics = micro(model, rows)
            for g, d in zip(grads, _grads(share, leaves)):
                g.copy_(d)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in microbatches(rows, grad_accum):
                share, total, _ = micro(model, mb)
                torch._foreach_add_(grads, [g.float() for g in
                                            _grads(share, leaves)])
                loss = loss + total
            torch._foreach_div_(grads, grad_accum)
            loss = loss / grad_accum
            metrics = {}
        for flat in buffers:
            reduce(flat)
        gnorm = global_norm(grads)
        with torch.no_grad():
            local_grads = {n: sharding.local_block(g, _of(sharded[n]))
                           for n, g in zip(names, grads)}
            opt = state["opt"]
            local_opt = {k: ({n: t.to_local() for n, t in v.items()}
                             if isinstance(v, dict) else v.to_local())
                         for k, v in opt.items()}
            local_params = {n: p.to_local() for n, p in sharded.items()}
            _, local_opt, om = optimizer.update(local_grads, local_opt,
                                                local_params, grad_norm=gnorm)
            opt["count"].to_local().copy_(local_opt["count"])
            state["step"].to_local().add_(1)
        return state, {"loss": loss, **metrics, **om}

    return train_step


# ---------------------------------------------------------------------------
# Serving: the counterparts of the reference's jitted prefill and
# ``serve_step`` over ``param_specs``, ``batch_specs`` and ``cache_specs``.
# ---------------------------------------------------------------------------

def shard_params(cfg, model: "lm.LM", mesh) -> "lm.LM":
    """An :class:`LM` whose parameters are DTensors placed by
    ``param_specs``, each rank keeping copies of its blocks of ``model``'s
    parameters (every rank passes the same whole model)."""
    shards = sharding.to_shardings(mesh, sharding.param_specs(cfg, model,
                                                              mesh))
    return _sharded_lm(cfg, {
        n: sharding.from_local(
            sharding.local_block(p.detach(), shards[n]).clone(), shards[n],
            tuple(p.shape))
        for n, p in model.named_parameters()})


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a cache tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves``, in :func:`_leaves`' order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def init_cache(cfg, batch: int, max_len: int, mesh, *, seq_shard=False,
               enc_len: int | None = None, device=None):
    """The serve cache of :func:`repro_torch.models.lm.init_cache` (or, for
    an encoder-decoder, ``encdec_init_cache`` with ``max_len`` decoder
    positions and ``enc_len`` frames) as DTensors placed by
    ``cache_specs(..., seq_shard=)``: each rank makes only its zero blocks,
    on ``device`` (None = the card)."""
    from ..api import resolve_device

    device = resolve_device(device)
    if cfg.encdec is not None:
        whole = lm.encdec_init_cache(cfg, batch, max_len, enc_len,
                                     device="meta")
    else:
        whole = lm.init_cache(cfg, batch, max_len, device="meta")
    specs = sharding.cache_specs(cfg, whole, mesh, seq_shard=seq_shard)

    def place(leaf, spec):
        block = torch.zeros(sharding.shard_shape(tuple(leaf.shape), spec,
                                                 mesh),
                            dtype=leaf.dtype, device=device)
        return sharding.from_local(block, sharding.to_shardings(mesh, spec),
                                   tuple(leaf.shape))

    return _zip_map(place, whole, specs)


def serve_rows(batch: dict, mesh) -> dict:
    """This rank's rows of the global serve batch ``batch`` (tensors, rows
    first): data rank r of D holds rows ``[r B / D, (r + 1) B / D)`` where D
    divides B, else every row (as ``batch_specs`` and ``cache_specs``
    replicate a batch they cannot split). Ranks along ``"model"`` get the
    same rows."""
    r, n = sharding.data_index(mesh)
    return {k: (x[r * (x.shape[0] // n):(r + 1) * (x.shape[0] // n)]
                if x.shape[0] % n == 0 else x).contiguous()
            for k, x in batch.items()}


class _Gathered:
    """The rank's whole model: a meta :class:`LM` whose parameters are set
    to the gathered tensors of a sharded one at each call (no copy where a
    mesh dim does not split them)."""

    def __init__(self, cfg):
        self.model = lm.LM(cfg, device="meta")

    def __call__(self, params):
        sharded = dict(params.named_parameters())
        names = [n for n, _ in self.model.named_parameters()]
        for n, t in zip(names, sharding.full_tensors([sharded[n]
                                                      for n in names])):
            _set_param(self.model, n, t)
        return self.model


def _cache_rows(cache):
    """(the rank's rows of every cache leaf, whole along every other dim,
    as a tree of tensors; the leaves' placements)."""
    leaves = _leaves(cache)
    rows = sharding.full_tensors(leaves, keep=1)
    return _rebuild(cache, iter(rows)), leaves


def _write_back(leaves, rows_tree) -> None:
    """Each DTensor leaf's block taken from the rank's rows (the rows' dim
    is already the rank's block)."""
    from torch.distributed.tensor import Replicate

    for leaf, rows in zip(leaves, _leaves(rows_tree)):
        plc = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
                    for p in leaf.placements)
        block = sharding.local_block(
            rows, sharding.Sharding(leaf.device_mesh, None, plc))
        local = leaf.to_local()
        if not same_memory(block, local):
            local.copy_(block)


def make_sharded_prefill_step(cfg, mesh):
    """prefill_step(params, rows, cache) -> (logits of the rank's rows,
    cache): the counterpart of the reference's prefill jitted over
    ``param_specs``, ``batch_specs`` and ``cache_specs``. ``params`` is a
    sharded :class:`LM` (:func:`shard_params`), ``rows`` the rank's rows of
    the batch (:func:`serve_rows`), ``cache`` a sharded cache
    (:func:`init_cache`), updated in place. Gather-then-compute: the
    parameters are gathered into one whole model, the cache's rows of the
    rank whole along the other dims, the one-device prefill runs on them,
    and each rank writes back its own blocks. With one data rank the
    logits and the cache are the one-device step's, bit for bit."""
    from .steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    whole = _Gathered(cfg)

    def prefill_step(params, rows, cache):
        model = whole(params)
        local, leaves = _cache_rows(cache)
        logits, local = prefill(model, rows, local)
        _write_back(leaves, local)
        return logits, cache

    return prefill_step


def make_sharded_decode_step(cfg, mesh):
    """decode_step(params, tokens, cache, cache_len) -> (next tokens,
    logits, cache) of the rank's rows: the counterpart of the reference's
    greedy ``serve_step`` jitted over the same specs (tokens over the data
    axes), gather-then-compute as :func:`make_sharded_prefill_step`.
    ``tokens`` are the rank's rows, ``cache_len`` an int."""
    from .steps import make_decode_step

    decode = make_decode_step(cfg, greedy=True)
    whole = _Gathered(cfg)

    def decode_step(params, tokens, cache, cache_len):
        model = whole(params)
        local, leaves = _cache_rows(cache)
        nxt, logits, local = decode(model, tokens, local, int(cache_len))
        _write_back(leaves, local)
        return nxt, logits, cache

    return decode_step
