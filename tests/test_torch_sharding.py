"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), on the CPU.

Specs: for every registry arch's smoke config (``fsdp`` off and on), the
port's spec of each parameter equals the reference's ``param_specs`` of the
leaf it is a layer of, with the layer-stack dim dropped; likewise
``state_specs`` (moments, master weights, ``count``, ``step``),
``batch_specs`` and ``cache_specs`` (batched and sequence-sharded). Each on
a (1, 1) and a (2, 4) mesh and the production shapes (16, 16) and (2, 16,
16): the rules read only a mesh's shape and axis names, so a stand-in
serves on both sides (as ``tests/test_sharding.py`` does). The divisibility
guard on ``test_divisibility_guard``'s cases. Specs are compared as lists
of entries, each None or the list of its axis names.

Placements: on 8 gloo ranks as the reference's (2, 4) mesh, each rank's
block shape of every leaf of a train state placed from the reference's
numpy state equals the reference's ``NamedSharding(mesh,
spec).shard_shape(shape)`` on 8 fake host devices (stack dim dropped), and
``to_shardings``' placements; and the placed state gathers back to the
numpy state, leaf for leaf.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_ref import run_ranks, run_reference
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.optim import AdamW

#: name -> (axis names, sizes).
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
#: Batch leaves: name -> shape (6 rows do not divide 4 or 32 data ranks).
BATCH = {"tokens": (8, 32), "labels": (8, 32), "mask": (8, 32),
         "embeds": (8, 32, 16), "odd": (6, 32), "scalar": ()}
CACHE = (8, 64)                   # batch, max_len
#: ``tests/test_sharding.py``'s divisibility cases: (spec, shape).
DIVISIBILITY = [((None, "model"), (10, 6)), (("data", "model"), (10, 8)),
                ((("data", "model"), None), (16, 3))]
#: The placed states on the 8 ranks.
PLACED_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b",
                "whisper-large-v3")


class StandIn:
    """A mesh's shape and axis names, all the rules read."""

    def __init__(self, name):
        self.axis_names, sizes = MESHES[name]
        self.shape = dict(zip(self.axis_names, sizes))


def canon(spec):
    """A spec (the port's P, JAX's PartitionSpec) -> a list of entries,
    each None or a list of axis names."""
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in spec]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "sharding", f"""
import dataclasses
import json
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, get_config
from repro.distributed import sharding as shd
from repro.models import lm
from repro.optim import AdamW
from repro.train import steps as tsteps

MESHES = {MESHES!r}
BATCH = {BATCH!r}
CACHE = {CACHE!r}
DIVISIBILITY = {DIVISIBILITY!r}
PLACED_ARCHS = {PLACED_ARCHS!r}


class StandIn:
    def __init__(self, name):
        self.axis_names, sizes = MESHES[name]
        self.shape = dict(zip(self.axis_names, sizes))


def canon(spec):
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in spec]


def specs_of(tree, specs):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(flat)
    return {{shd._path_str(p): canon(s) for (p, _), s in zip(leaves, flat)}}


out = {{}}
for arch in ARCHS:
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=fsdp)
        state = jax.eval_shape(lambda k: tsteps.init_train_state(
            k, cfg, AdamW(lr=1e-3)), jax.random.key(0))
        if cfg.encdec is not None:
            cache = jax.eval_shape(lambda: lm.encdec_init_cache(
                cfg, *CACHE, CACHE[1]))
        else:
            cache = jax.eval_shape(lambda: lm.init_cache(cfg, *CACHE))
        for mesh in MESHES:
            m = StandIn(mesh)
            out[f"{{arch}}/{{fsdp}}/{{mesh}}/state"] = specs_of(
                state, shd.state_specs(cfg, state, m))
            for seq in (False, True):
                out[f"{{arch}}/{{fsdp}}/{{mesh}}/cache/{{seq}}"] = specs_of(
                    cache, shd.cache_specs(cfg, cache, m, seq_shard=seq))
for mesh in MESHES:
    batch = {{k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in BATCH.items()}}
    out[f"batch/{{mesh}}"] = specs_of(batch, shd.batch_specs(None, batch,
                                                           StandIn(mesh)))
out["divisibility"] = [canon(shd.fix_divisibility(P(*s), shape, StandIn("2x4")))
                       for s, shape in DIVISIBILITY]

# Block shapes on the (2, 4) mesh of 8 fake devices.
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"))
for arch in PLACED_ARCHS:
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    state = jax.eval_shape(lambda k: tsteps.init_train_state(
        k, cfg, AdamW(lr=1e-3)), jax.random.key(0))
    specs = shd.state_specs(cfg, state, mesh)
    leaves = jax.tree_util.tree_leaves_with_path(state)
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    out[f"shapes/{{arch}}"] = {{
        shd._path_str(p): list(NamedSharding(mesh, s).shard_shape(x.shape))
        for (p, x), s in zip(leaves, flat)}}
res["json"] = np.asarray(json.dumps(out))
""", env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})


@pytest.fixture(scope="module")
def ref(reference):
    return json.loads(str(reference["json"]))


def _stacked(path: str) -> bool:
    return convert._stacked(path.split("/"))


def _flat_specs(tree, prefix="") -> dict:
    """A spec tree (dicts, lists) -> {"0/k": canon spec}."""
    if isinstance(tree, sharding.P):
        return {prefix[:-1]: canon(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}{k}/"))
    return out


def _port_leaf_specs(cfg, specs: dict) -> dict:
    """Port name -> canon spec, from ``{port name: P}``."""
    return {n: canon(s) for n, s in specs.items()}


def _want(ref_specs: dict, prefix: str, cfg) -> dict:
    """The reference's specs of the parameter-shaped tree under ``prefix``
    as port name -> canon spec, the stack dim dropped."""
    out = {}
    for path, names in convert._leaf_names(cfg):
        key = prefix + "/".join(str(p) for p in path)
        spec = ref_specs[key]
        if _stacked(key[len(prefix):]):
            assert spec[0] is None, (key, spec)
            spec = spec[1:]
        for n in names:
            out[n] = spec
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(ref, arch, mesh):
    """Every parameter's, moment's and master weight's spec, and ``count``
    and ``step`` replicated, with ``fsdp`` off and on."""
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=fsdp)
        model = lm.LM(cfg, device="meta")
        state = {"params": model, "opt": AdamW(lr=1e-3).init(model),
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        got = sharding.state_specs(cfg, state, StandIn(mesh))
        want = ref[f"{arch}/{fsdp}/{mesh}/state"]
        assert _port_leaf_specs(cfg, got["params"]) == _want(
            want, "params/", cfg), (arch, fsdp, mesh)
        assert got["params"] == sharding.param_specs(cfg, model,
                                                     StandIn(mesh))
        for k in ("m", "v", "master"):
            assert _port_leaf_specs(cfg, got["opt"][k]) == _want(
                want, f"opt/{k}/", cfg), (arch, fsdp, mesh, k)
        assert canon(got["opt"]["count"]) == want["opt/count"] == []
        assert canon(got["step"]) == want["step"] == []


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(ref, arch, mesh):
    """The serve cache's specs (the port's cache has the reference's
    layout), batched and sequence-sharded."""
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=fsdp)
        if cfg.encdec is not None:
            cache = lm.encdec_init_cache(cfg, *CACHE, CACHE[1],
                                         device="meta")
        else:
            cache = lm.init_cache(cfg, *CACHE, device="meta")
        for seq in (False, True):
            got = sharding.cache_specs(cfg, cache, StandIn(mesh),
                                       seq_shard=seq)
            flat = _flat_specs(got)
            assert flat == ref[f"{arch}/{fsdp}/{mesh}/cache/{seq}"], (
                arch, fsdp, mesh, seq)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_reference(ref, mesh):
    batch = {k: torch.empty(s) for k, s in BATCH.items()}
    got = sharding.batch_specs(None, batch, StandIn(mesh))
    assert {k: canon(s) for k, s in got.items()} == ref[f"batch/{mesh}"]


def test_divisibility_guard(ref):
    """``tests/test_sharding.py``'s cases, as the reference gives them."""
    mesh = StandIn("2x4")
    got = [canon(sharding.fix_divisibility(sharding.P(*s), shape, mesh))
           for s, shape in DIVISIBILITY]
    assert got == ref["divisibility"]
    assert got == [[None, None], [["data"], ["model"]],
                   [["data", "model"], None]]


def test_placements():
    """Specs to DTensor placements, by mesh dim: a folded entry shards its
    dim on each of its mesh dims (in the mesh's order), an axis used twice
    or folded out of order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    two = StandIn("2x4")
    pods = StandIn("2x16x16")
    assert sharding.placements(sharding.P("model", "data"), two) == (
        Shard(1), Shard(0))
    assert sharding.placements(sharding.P(None, "model"), two) == (
        Replicate(), Shard(1))
    assert sharding.placements(sharding.P(), two) == (Replicate(),
                                                      Replicate())
    assert sharding.placements(sharding.P(("pod", "data"), "model"),
                               pods) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        sharding.placements(sharding.P(("data", "pod"), None), pods)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(sharding.P("data", "data"), two)
    assert sharding.shard_shape((16, 8), sharding.P(("pod", "data"), "model"),
                                pods) == (16 // 32, 8 // 16)


_PLACED = f"""
import dataclasses
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import sharding


def flat_tree(tree, prefix):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tree(v, f"{{prefix}}/{{k}}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_tree(v, f"{{prefix}}/{{i}}")
    else:
        yield prefix, np.asarray(tree)


mesh = mesh_of((2, 4))
for arch in {PLACED_ARCHS!r}:
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    tree = convert.numpy_lm_params(cfg, 0)
    rng = np.random.default_rng(1)
    noise = convert._map_tree(
        lambda x: rng.standard_normal(x.shape, dtype=np.float32), tree)
    numpy_state = {{"params": tree, "opt": {{"m": noise, "v": noise,
                   "master": tree, "count": np.int32(3)}},
                   "step": np.int32(3)}}
    state = convert.train_state_from_numpy(cfg, numpy_state, device="cpu",
                                           mesh=mesh)
    specs = sharding.state_specs(cfg, state, mesh)
    shards = sharding.to_shardings(mesh, specs)
    leaves = [(f"params/{{n}}", p, shards["params"][n])
              for n, p in state["params"].named_parameters()]
    for k in ("m", "v", "master"):
        leaves += [(f"opt/{{k}}/{{n}}", x, shards["opt"][k][n])
                   for n, x in state["opt"][k].items()]
    for name, x, sh in leaves:
        res[f"{{arch}}/shape/{{name}}"] = np.asarray(x.to_local().shape)
        assert tuple(x.placements) == sh.placements, name
        assert tuple(x.to_local().shape) == sharding.shard_shape(
            tuple(x.shape), sh.spec, mesh), name
    for k, v in convert.train_state_to_numpy(state).items():
        if rank == 0:
            for path, leaf in flat_tree(v, k):
                res[f"{{arch}}/state/{{path}}"] = leaf
"""


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    return run_ranks(tmp_path_factory, "placed", 8, _PLACED)


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_block_shapes_match_reference_on_2x4(ref, placed, arch):
    """Every rank's block shape of every leaf equals the reference's
    ``shard_shape`` on the (2, 4) mesh (the stack dim dropped)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    shapes = ref[f"shapes/{arch}"]
    for prefix in ("params/", "opt/m/", "opt/v/", "opt/master/"):
        for path, names in convert._leaf_names(cfg):
            key = prefix + "/".join(str(p) for p in path)
            want = shapes[key][1:] if convert._stacked(path) else shapes[key]
            for n in names:
                for r, res in enumerate(placed):
                    got = res[f"{arch}/shape/{prefix}{n}"].tolist()
                    assert got == want, (arch, r, key, n, got, want)


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_state_gathers_back(placed, arch):
    """A state placed from numpy on the (2, 4) mesh gathers back to the
    numpy state, leaf for leaf, bit for bit."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    tree = convert.numpy_lm_params(cfg, 0)
    rng = np.random.default_rng(1)
    noise = convert._map_tree(
        lambda x: rng.standard_normal(x.shape, dtype=np.float32), tree)
    want = {}
    for k, v in {"params": tree, "opt/m": noise, "opt/v": noise,
                 "opt/master": tree}.items():
        for path, names in convert._leaf_names(cfg):
            node = v
            for p in path:
                node = node[p]
            want[f"{k}/" + "/".join(str(p) for p in path)] = node
    got = {k[len(arch) + 7:]: v for k, v in placed[0].items()
           if k.startswith(f"{arch}/state/")}
    assert int(got.pop("opt/count")) == 3 and int(got.pop("step")) == 3
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
