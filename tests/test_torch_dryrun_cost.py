"""The dry-run's counters on the CPU: the port's stand-ins for the
reference's HLO readers (``repro_torch.distributed.cost``, ``collectives``)
and the parameter counts (``repro_torch.models.lm``).

  * ``param_count`` and ``active_param_count`` of every arch's full config
    equal the reference's (``jax.eval_shape`` of its ``init``), exactly;
  * ``collectives._traffic`` equals the reference's ``hlo._traffic`` on a
    table of kinds x bytes x group sizes (S = 1 included), and
    ``collective_bytes`` sums records into the reference's keys;
  * ``cost.analyze`` of a smoke dense train step on fake tensors counts the
    FLOPs that ``FlopCounterMode`` counts around the same step on real CPU
    tensors, exactly; bytes are each op's operands and results, views and
    ``empty`` free; the peak follows live storage;
  * kernel 5 on fake tensors launches nothing, returns the kernel's shape
    and dtype and charges exactly the closed-form work of the kernels
    line's bound; it refuses a mix of fake and real tensors;
  * a fake run leaves no fake tensor in the per-device constant caches.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from _torch_ref import run_reference
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import collectives, cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.train.steps import make_train_step

KINDS = collectives.COLLECTIVES
NBYTES = (0, 1, 4096, 123_456_789)
GROUPS = (1, 2, 3, 16, 512)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "dryrun_counts", f"""
from repro.configs import ARCHS, get_config
from repro.distributed.hlo import _traffic
from repro.models import lm

for arch in ARCHS:
    cfg = get_config(arch)
    res[f"{{arch}}/param_count"] = np.int64(lm.param_count(cfg))
    res[f"{{arch}}/active_param_count"] = np.int64(lm.active_param_count(cfg))
for kind in {KINDS!r}:
    for b in {NBYTES!r}:
        for s in {GROUPS!r}:
            res[f"traffic/{{kind}}/{{b}}/{{s}}"] = np.float64(_traffic(kind, b, s))
""")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(reference, arch):
    cfg = get_config(arch)
    assert lm.param_count(cfg) == int(reference[f"{arch}/param_count"])
    assert lm.active_param_count(cfg) == int(
        reference[f"{arch}/active_param_count"])


@pytest.mark.parametrize("kind", KINDS)
def test_traffic_equals_reference(reference, kind):
    for b, s in itertools.product(NBYTES, GROUPS):
        assert collectives._traffic(kind, b, s) == float(
            reference[f"traffic/{kind}/{b}/{s}"]), (kind, b, s)


def test_collective_bytes_sums_records():
    out = collectives.collective_bytes([("all-gather", 800, 4),
                                        ("all-gather", 200, 2),
                                        ("all-reduce", 64, 2),
                                        ("all-reduce", 64, 1)])
    assert out["all-gather"] == {"bytes": 1000, "traffic_bytes": 700.0,
                                 "count": 2}
    assert out["all-reduce"] == {"bytes": 128, "traffic_bytes": 64.0,
                                 "count": 2}
    assert (out["total_bytes"], out["total_traffic"], out["total_count"]) == (
        1128, 764.0, 4)
    with pytest.raises(ValueError, match="unknown collective"):
        collectives.collective_bytes([("broadcast", 1, 2)])


def _train_step(cfg, fake: bool):
    """The smoke train step's (result, flops): under an Analysis on fake
    tensors, or under FlopCounterMode on real ones."""
    rows = {"tokens": torch.zeros((4, 64), dtype=torch.int32),
            "labels": torch.ones((4, 64), dtype=torch.int32)}
    if fake:
        with FakeTensorMode():
            params = lm.LM(cfg, device="cpu").requires_grad_(True)
            state = {"params": params, "opt": AdamW().init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            rows = {k: torch.zeros(v.shape, dtype=v.dtype)
                    for k, v in rows.items()}
            with cost.Analysis() as a:
                a.track(state)
                make_train_step(cfg, AdamW())(state, rows)
        return a, a.result()["flops"]
    params = lm.init(torch.Generator().manual_seed(0), cfg).requires_grad_(True)
    state = {"params": params, "opt": AdamW().init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    counter = FlopCounterMode(display=False)
    with counter:
        make_train_step(cfg, AdamW())(state, rows)
    return counter, counter.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_fake_step_counts_flop_counter_flops(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_chunk=16)
    a, fake_flops = _train_step(cfg, fake=True)
    _, real_flops = _train_step(cfg, fake=False)
    assert real_flops > 0
    assert fake_flops == real_flops
    res = a.result()
    assert res["unknown_trips"] == [] and res["collective_count"] == 0
    assert a.peak_bytes > 0 and res["bytes"] > 0
    assert sum(v["flops"] for v in a._by_module.values()) == fake_flops


def test_bytes_and_peak_of_known_ops():
    with FakeTensorMode():
        x = torch.empty((64, 32))                        # free: empty
        w = torch.empty((32, 16))
        with cost.Analysis() as a:
            a.track([x, w])
            y = x @ w                                    # 8192 + 2048 + 4096
            z = y.t()                                    # a view: free
            s = torch.zeros((1000,))                     # writes 4000 bytes
            del s
            u = z * 2.0                                  # 4096 + 4096
        res = a.result()
    assert res["flops"] == 2 * 64 * 32 * 16
    assert res["bytes"] == (8192 + 2048 + 4096) + 4000 + (4096 + 4096)
    # the arguments' 10,240 bytes, y's 4,096 and s's 4,000 (freed), then
    # u's 4,096 beside y
    assert a.peak_bytes == 10240 + 4096 + 4096
    assert a.live == 10240 + 4096 + 4096
    del y, z, u
    assert a.live == 10240


#: (B, Tq, Hq, Hkv, Tkv, D, causal, kv_len, dtype)
CHARGE_CASES = [
    (2, 33, 4, 2, 70, 64, True, [40, 70], torch.float32),
    (8, 2048, 14, 2, 2048, 64, True, None, torch.bfloat16),
    (8, 1, 14, 2, 2080, 64, True, 1500, torch.bfloat16),
    (3, 17, 20, 20, 1500, 64, False, None, torch.float32),
    (1, 5, 8, 8, 9, 128, False, [9], torch.bfloat16),
]


def _closed_form(b, tq, hq, hkv, tkv, d, causal, kv_len, dtype):
    """The chip script's ``flash_work``: a row-by-row count."""
    lens = ([tkv] * b if kv_len is None else
            [kv_len] * b if isinstance(kv_len, int) else kv_len)
    pairs = sum(min(n, i + n - tq + 1) if causal else n
                for n in lens for i in range(tq))
    elem = torch.tensor([], dtype=dtype).element_size()
    return (4 * d * hq * pairs,
            elem * (2 * b * tq * hq * d + 2 * sum(lens) * hkv * d))


@pytest.mark.parametrize("case", range(len(CHARGE_CASES)))
def test_kernel5_fake_call_charges_closed_form(case):
    b, tq, hq, hkv, tkv, d, causal, kv_len, dtype = CHARGE_CASES[case]
    fa.reset_launches()
    with FakeTensorMode():
        q = torch.empty((b, tq, hq, d), dtype=dtype)
        k = torch.empty((b, tkv, hkv, d), dtype=dtype)
        res = cost.analyze(fa.attention, q, k, k, causal=causal,
                           kv_len=kv_len)
        with cost.Analysis() as a:
            out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     k.transpose(1, 2), causal=causal,
                                     kv_len=kv_len)
    flops, nbytes = _closed_form(*CHARGE_CASES[case])
    assert (res["flops"], res["bytes"]) == (flops, nbytes)
    assert (a.flops, a.bytes) == (flops, nbytes)
    assert out.shape == (b, hq, tq, d) and out.dtype == dtype
    assert all(n == 0 for n in fa.launches.values())
    assert list(a.profile()) == ["Global/flash_attention"]


def test_kernel5_refuses_mixed_fake_and_real():
    k = torch.zeros((1, 4, 1, 8))
    with FakeTensorMode():
        q = torch.empty((1, 4, 1, 8))
        with pytest.raises(ValueError, match="all be fake tensors or none"):
            fa._fake(q, k, k)


def test_fake_run_leaves_no_fake_constant():
    """A fake forward makes its per-device constants (RoPE frequencies,
    sinusoids) afresh: a real forward after it, on the same shapes, gives
    the same logits as before it."""
    cfg = get_config("whisper-large-v3", smoke=True)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    tokens = torch.zeros((2, 4), dtype=torch.int32)

    def run():
        with torch.no_grad():
            return lm.forward_encdec(params, cfg, frames, tokens)[0]

    before = run()
    qcfg = get_config("qwen2-0.5b", smoke=True)
    with FakeTensorMode():
        lm.forward_encdec(lm.LM(cfg, device="cpu"), cfg,
                          torch.empty(frames.shape), torch.zeros((2, 4),
                                                                 dtype=torch.int32))
        lm.forward(lm.LM(qcfg, device="cpu"), qcfg,
                   tokens=torch.zeros((2, 4), dtype=torch.int32))
    torch.testing.assert_close(run(), before, rtol=0, atol=0)
    with torch.no_grad():
        h, _ = lm.forward(lm.init(torch.Generator().manual_seed(0), qcfg),
                          qcfg, tokens=tokens)
    assert torch.isfinite(h).all()
