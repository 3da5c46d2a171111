"""The port's sharded serve steps (``repro_torch.train.sharded``'s
``make_sharded_prefill_step`` and ``make_sharded_decode_step``) on the CPU:
the counterparts of the reference's prefill and greedy ``serve_step`` jitted
over ``param_specs``, ``batch_specs`` and ``cache_specs`` (its
``launch/dryrun.py`` ``build_cell``).

  * on a 1x1 gloo mesh in this process, every family (dense, MoE with MLA,
    the hybrid, whisper, the VLM, the pure SSM): the logits, tokens and
    cache equal the one-device ``make_prefill_step``/``make_decode_step``'s
    bit for bit;
  * on a 2x4 mesh of 8 gloo ranks (4 rows a data rank; parameters and the
    cache's heads split over ``"model"``), the dense, MoE, hybrid and
    whisper cases: each rank's rows' logits within 1e-5 of the largest
    logit of the one-device run (float32; the ranks' products see 4 of the
    8 rows), the tokens equal, each rank's cache block within 1e-5 of the
    one-device cache's block;
  * the dense case against the reference's own jitted sharded prefill and
    ``serve_step`` on a 2x4 mesh of 8 fake host devices: every rank's
    rows' logits within 1e-4 of the largest logit (XLA against torch in
    float32), the tokens equal.
"""
import numpy as np
import pytest

from _torch_ref import one_rank_mesh, run_ranks, run_reference
import _torch_serve as S


@pytest.fixture(scope="module")
def one_device():
    return {case: S.run_one_device(case) for case in S.ONE_RANK_CASES}


@pytest.mark.parametrize("case", sorted(S.ONE_RANK_CASES))
def test_one_rank_mesh_is_one_device(tmp_path, one_device, case):
    with one_rank_mesh(tmp_path) as mesh:
        got = S.run_sharded(case, mesh)
    S.assert_rank_matches(got, one_device[case], exact=True, label=case)


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    return run_ranks(tmp_path_factory, "serve_2x4", 8,
                     "MESH = (2, 4)\n" + S.RANK_BODY)


@pytest.mark.parametrize("case", sorted(S.CASES))
def test_2x4_rows_and_blocks(ranks_2x4, one_device, case):
    for r, res in enumerate(ranks_2x4):
        got = S.case_of(res, case)
        assert int(got["rows"][1]) == S.B // 2
        S.assert_rank_matches(got, one_device[case], exact=False, tol=1e-5,
                              label=f"{case} rank {r}")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "serve_sharded", """
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
import _torch_serve as S
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.mesh import _make_mesh
from repro.models import lm
from repro.train import steps as tsteps
from repro_torch import convert

assert len(jax.devices()) == 8
mesh = _make_mesh((2, 4), ("data", "model"))
cfg = S.config("dense", get_config)
params = jax.tree.map(jnp.asarray,
                      convert.numpy_lm_params(S.config("dense"), 0))
batch = {k: jnp.asarray(v) for k, v in S.inputs(cfg).items()}
cache = lm.init_cache(cfg, S.B, S.P + S.GEN)
ps = shd.to_shardings(mesh, shd.param_specs(cfg, params, mesh))
bs = shd.to_shardings(mesh, shd.batch_specs(cfg, batch, mesh))
cs = shd.to_shardings(mesh, shd.cache_specs(cfg, cache, mesh,
                                            seq_shard=False))
prefill = jax.jit(tsteps.make_prefill_step(cfg), in_shardings=(ps, bs, cs),
                  out_shardings=(None, cs))
dstep = tsteps.make_decode_step(cfg)


def serve_step(params, tokens, cache, cache_len):
    nxt, logits, cache = dstep(params, tokens, cache, cache_len)
    return nxt, logits, cache


serve = jax.jit(serve_step, in_shardings=(
    ps, NamedSharding(mesh, PartitionSpec(shd.data_axes(mesh))), cs,
    NamedSharding(mesh, PartitionSpec())), out_shardings=(None, None, cs))
with mesh:
    logits, cache = prefill(params, batch, cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    res["logits/0"], res["tokens/0"] = np.asarray(logits), np.asarray(tok)
    for i in range(1, S.GEN):
        tok, logits, cache = serve(params, tok, cache,
                                   jnp.int32(S.P + i - 1))
        res[f"logits/{i}"] = np.asarray(logits)
        res[f"tokens/{i}"] = np.asarray(tok)
""", env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})


def test_2x4_dense_matches_reference(reference, ranks_2x4):
    for r, res in enumerate(ranks_2x4):
        got = S.case_of(res, "dense")
        start, count = (int(x) for x in got["rows"])
        for i in range(S.GEN):
            want = reference[f"logits/{i}"][start:start + count]
            np.testing.assert_allclose(
                got[f"logits/{i}"], want, rtol=0,
                atol=1e-4 * np.abs(want).max(), err_msg=f"rank {r} step {i}")
            np.testing.assert_array_equal(
                got[f"tokens/{i}"],
                reference[f"tokens/{i}"][start:start + count])
