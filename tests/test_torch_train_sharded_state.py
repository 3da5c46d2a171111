"""A sharded train state moved between meshes, on the CPU: elastic
``remesh`` (``repro_torch.distributed.elastic``), sharded checkpoints
(``repro_torch.checkpoint.manager``) and each rank's rows of the global
batch (``repro_torch.train.sharded.batch_rows``).

  * the counterpart of ``tests/test_distributed_extras.py``'s
    ``test_elastic_remesh_roundtrip``: a fresh state re-placed on a 1x1
    mesh keeps every leaf; ``rescale_batch`` and its error;
  * on 8 gloo ranks: the qwen2-0.5b smoke state (``fsdp=True``) after one
    sharded step on a (2, 4) mesh, re-placed on (4, 2) within the same
    ranks, gathers to the same values; its checkpoint, written by rank 0
    (every rank gathering), restores on 4 ranks as a (2, 2) mesh and on
    one device, leaf for leaf, bit for bit, in the reference's layout;
  * the data: every rank draws the global batch and keeps its rows, its
    data block of each microbatch, whatever rank of ``"model"`` it is.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import one_rank_mesh, run_ranks
from _torch_train import flat
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticCopyTask
from repro_torch.distributed.elastic import remesh, rescale_batch
from repro_torch.optim import AdamW
from repro_torch.train import sharded
from repro_torch.train.steps import init_train_state

ARCH = "qwen2-0.5b"


def config():
    return dataclasses.replace(get_config(ARCH, smoke=True), fsdp=True)


def test_elastic_remesh_roundtrip(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             AdamW(lr=1e-3))
    with one_rank_mesh(tmp_path) as mesh:
        state2 = remesh(cfg, state, mesh)
        assert sharded.is_sharded(state2)
        a = flat(convert.train_state_to_numpy(state))
        b = flat(convert.train_state_to_numpy(state2))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert rescale_batch(256, 16, 8) == 32
    with pytest.raises(ValueError, match="not divisible by 7 hosts"):
        rescale_batch(256, 16, 7)


def _body(ckpt: str) -> str:
    return f"""
import dataclasses
import sys
sys.path.insert(0, "tests")
import _torch_train as T
import test_torch_train_sharded_state as S
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.elastic import remesh
from repro_torch.optim import AdamW
from repro_torch.train import sharded

cfg = S.config()
opt = AdamW(lr=1e-3)
mesh = mesh_of((2, 4))
state = sharded.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                 mesh)
rows = sharded.batch_rows(S.batch(cfg), mesh)
step = sharded.make_sharded_train_step(cfg, opt, mesh)
state, _ = step(state, {{k: torch.from_numpy(v) for k, v in rows.items()}})
before = T.flat(convert.train_state_to_numpy(state))
cm = CheckpointManager({ckpt!r}, keep_n=2, async_save=True)
cm.save(1, state)
cm.wait()
moved = remesh(cfg, state, mesh_of((4, 2)))
shapes = {{n: tuple(p.to_local().shape)
          for n, p in moved["params"].named_parameters()}}
after = T.flat(convert.train_state_to_numpy(moved))
if rank == 0:
    res.update({{f"before/{{k}}": v for k, v in before.items()}})
    res.update({{f"after/{{k}}": v for k, v in after.items()}})
res["wq_block"] = np.asarray(shapes["blocks.0.attn.wq.w"])
"""


_RESTORE = """
import sys
sys.path.insert(0, "tests")
import _torch_train as T
import test_torch_train_sharded_state as S
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim import AdamW
from repro_torch.train import sharded

template = sharded.init_train_state(torch.Generator().manual_seed(5),
                                    S.config(), AdamW(lr=1e-3),
                                    mesh_of((2, 2)))
state = CheckpointManager(CKPT).restore_latest(template)
assert sharded.is_sharded(state)
res["wq_block"] = np.asarray(state["params"].blocks[0].attn.wq.w
                             .to_local().shape)
got = T.flat(convert.train_state_to_numpy(state))
if rank == 0:
    res.update(got)
"""


def batch(cfg):
    return SyntheticCopyTask(cfg.vocab_size, batch=8, seq=16,
                             seed=0).batch_at(0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_ckpt")


@pytest.fixture(scope="module")
def eight(tmp_path_factory, ckpt):
    return run_ranks(tmp_path_factory, "remesh", 8, _body(str(ckpt)))


@pytest.fixture(scope="module")
def four(tmp_path_factory, ckpt, eight):
    return run_ranks(tmp_path_factory, "restore", 4,
                     f"CKPT = {str(ckpt)!r}\n" + _RESTORE)


def _prefixed(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _assert_equal(got: dict, want: dict, label):
    assert got.keys() == want.keys(), (label, set(got) ^ set(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


def test_remesh_2x4_to_4x2(eight):
    """Every value equal after the move; the blocks are the new mesh's
    (``wq`` [64, 64] is (fsdp, "model"): 32 x 16 on (2, 4), 16 x 32 on
    (4, 2))."""
    _assert_equal(_prefixed(eight[0], "after/"), _prefixed(eight[0],
                                                           "before/"), "")
    assert all(r["wq_block"].tolist() == [16, 32] for r in eight)


def test_checkpoint_from_8_ranks_restores_on_4(eight, four):
    want = _prefixed(eight[0], "before/")
    _assert_equal({k: v for k, v in four[0].items() if k != "wq_block"},
                  want, "4 ranks")
    assert all(r["wq_block"].tolist() == [32, 32] for r in four)


def test_checkpoint_from_8_ranks_restores_on_one_device(eight, ckpt):
    template = init_train_state(torch.Generator().manual_seed(5), config(),
                                AdamW(lr=1e-3))
    state = CheckpointManager(str(ckpt)).restore_latest(template)
    assert not sharded.is_sharded(state)
    _assert_equal(flat(convert.train_state_to_numpy(state)),
                  _prefixed(eight[0], "before/"), "one device")
    assert sorted(p.name for p in ckpt.iterdir()) == ["LATEST",
                                                      "step_00000001"]


class _Mesh:
    """A stand-in for a DeviceMesh: its dim names, sizes and this rank's
    coordinate (all ``batch_rows`` reads)."""

    def __init__(self, names, shape, coord):
        self.mesh_dim_names, self.shape = names, shape
        self._coord = coord

    def get_coordinate(self):
        return list(self._coord)

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_each_rank_keeps_its_rows_of_the_global_batch(grad_accum):
    """On a (2, 4) mesh and a (2, 2, 2) mesh with pods, the data ranks'
    rows of each microbatch, in data order, are that microbatch of the
    global batch (the reference's draw as host 0 of 1, microbatch i its
    rows [i B / ga, (i + 1) B / ga)); ranks along ``"model"`` get the same
    rows."""
    cfg = get_config(ARCH, smoke=True)
    glob = SyntheticCopyTask(cfg.vocab_size, batch=16, seq=16,
                             seed=0).batch_at(3)
    for names, shape in ((("data", "model"), (2, 4)),
                         (("pod", "data", "model"), (2, 2, 2))):
        ndata = int(np.prod(shape[:-1]))
        per = 16 // grad_accum // ndata
        for coord in np.ndindex(*shape):
            rows = sharded.batch_rows(glob, _Mesh(names, shape, coord),
                                      grad_accum)
            r = int(np.ravel_multi_index(coord[:-1], shape[:-1]))
            for k, x in glob.items():
                micro = x.reshape(grad_accum, 16 // grad_accum,
                                  *x.shape[1:])
                want = micro[:, r * per:(r + 1) * per].reshape(
                    -1, *x.shape[1:])
                np.testing.assert_array_equal(rows[k], want, err_msg=k)
    with pytest.raises(ValueError, match="do not split"):
        sharded.batch_rows(glob, _Mesh(("data", "model"), (3, 1), (0, 0)))
