"""The collective records of a sharded train step (``sharding.records``,
read by ``repro_torch.distributed.collectives.collective_bytes``) on 8
gloo ranks as a 2x4 mesh, against the closed form of the step's gathers
and reduces.

The step (qwen2-0.5b's smoke config, ``fsdp=True``, float32) gathers the
parameters along ``"model"`` (4 ranks) and then ``"data"`` (2 ranks), one
all-gather a mesh dim (one dtype), each of S x the blocks it hands in; then
it reduces over the 2 data ranks the loss's four sums and the MoE drop
count (5 float32 values) and the gradient buffer (every parameter's
gradient, float32). ``stats["bytes"]`` counts the payloads handed in.
"""
import dataclasses
import math

import pytest

from _torch_ref import run_ranks
from repro_torch.configs import get_config
from repro_torch.distributed import collectives, sharding
from repro_torch.launch.dryrun import MeshShape
from repro_torch.models import lm

MESH = (2, 4)
BODY = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.optim import AdamW
from repro_torch.train import sharded

mesh = mesh_of((2, 4))
cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), fsdp=True)
opt = AdamW(lr=1e-3)
state = sharded.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                 mesh)
rows = {k: torch.zeros((2, 16), dtype=torch.int32) for k in ("tokens",
                                                              "labels")}
sharding.reset_stats()
sharded.make_sharded_train_step(cfg, opt, mesh)(state, rows)
res["kind"] = np.array([k for k, _, _ in sharding.records])
res["bytes"] = np.array([b for _, b, _ in sharding.records])
res["group"] = np.array([s for _, _, s in sharding.records])
res["payload"] = np.array(sharding.stats["bytes"])
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, "dryrun_collectives", 8, BODY)


def closed_form():
    """(the step's records, the payload bytes handed in)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), fsdp=True)
    mesh = MeshShape(("data", "model"), {"data": 2, "model": 4})
    meta = lm.LM(cfg, device="meta")
    specs = sharding.param_specs(cfg, meta, mesh)

    def over(spec, axis):
        return any(axis in sharding._axes(e) for e in spec)

    sizes = {n: p.numel() * 4 for n, p in meta.named_parameters()}
    # "model" first: each block, 1 / (D x M) or 1 / M of the parameter
    model = sum(sizes[n] // (2 if over(specs[n], "data") else 1) // 4
                for n in sizes if over(specs[n], "model"))
    # then "data": each tensor whole along "model" by now
    data = sum(sizes[n] // 2 for n in sizes if over(specs[n], "data"))
    grads = sum(sizes.values())
    records = [("all-gather", 4 * model, 4), ("all-gather", 2 * data, 2),
               ("all-reduce", 5 * 4, 2), ("all-reduce", grads, 2)]
    return records, model + data + 20 + grads


def test_records_are_the_closed_form(ranks):
    want, payload = closed_form()
    for r, res in enumerate(ranks):
        got = [(str(k), int(b), int(s)) for k, b, s in
               zip(res["kind"], res["bytes"], res["group"])]
        assert got == want, f"rank {r}"
        assert int(res["payload"]) == payload


def test_collective_bytes_of_the_step(ranks):
    want, _ = closed_form()
    res = ranks[0]
    out = collectives.collective_bytes(zip(res["kind"].tolist(),
                                           res["bytes"].tolist(),
                                           res["group"].tolist()))
    (_, g_model, _), (_, g_data, _), (_, r_loss, _), (_, r_grad, _) = want
    assert out["all-gather"] == {
        "bytes": g_model + g_data, "count": 2,
        "traffic_bytes": g_model * 3 / 4 + g_data / 2}
    assert out["all-reduce"] == {"bytes": r_loss + r_grad, "count": 2,
                                 "traffic_bytes": r_loss + r_grad}
    assert out["total_count"] == 4
    assert math.isclose(out["total_traffic"], g_model * 3 / 4 + g_data / 2
                        + r_loss + r_grad, rel_tol=0, abs_tol=0)
