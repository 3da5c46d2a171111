"""The port's int8-compressed gradient reduce
(``repro_torch.distributed.compression``) against the reference's, on the
CPU: ``compress_roundtrip`` bit for bit on a tree of gradients and error
residuals, over three rounds of error feedback; the counterparts of
``tests/test_distributed_extras.py``'s compression tests; and
``make_compressed_psum`` on 8 gloo ranks against the reference's inside a
``shard_map`` over 8 fake host devices, bit for bit in the mean and the new
error, two rounds (the second from the first's error).
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_ranks, run_reference
from repro_torch.distributed import compression as comp

#: Leaf shapes of the gradient trees (a 0-d leaf and an all-zero one too).
SHAPES = {"w": (64, 48), "b": (48,), "deep": {"k": (3, 5, 7)},
          "zero": (4,)}
RANKS = 8
ROUNDS = 2


def tree_of(fn, shapes=SHAPES):
    return {k: tree_of(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in shapes.items()}


def grads(seed: int):
    """A gradient tree from ``seed`` (scales apart leaf to leaf; the zero
    leaf all zeros: the scale's 1e-12 floor)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "zero":
            return np.zeros(shape, np.float32)
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(10.0 ** rng.integers(-4, 2)))

    return tree_of(leaf)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "compression", f"""
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import test_torch_compression as S
from repro.distributed import compression as comp

T = lambda tree: jax.tree.map(jnp.asarray, tree)
err = comp.init_error(T(S.grads(0)))
for i in range(3):
    g_hat, err = comp.compress_roundtrip(T(S.grads(i)), err)
    res.update(S.flat(jax.tree.map(np.asarray, g_hat), f"roundtrip/{{i}}/g/"))
    res.update(S.flat(jax.tree.map(np.asarray, err), f"roundtrip/{{i}}/e/"))

# The psum: rank r's trees stacked on a leading axis of 8, one a device.
assert len(jax.devices()) == S.RANKS
mesh = jax.make_mesh((S.RANKS,), ("d",))
stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
psum_c = comp.make_compressed_psum("d")


def body(g, e):
    squeeze = lambda t: jax.tree.map(lambda x: x[0], t)
    mean, new = psum_c(squeeze(g), squeeze(e))
    expand = lambda t: jax.tree.map(lambda x: x[None], t)
    return expand(mean), expand(new)


f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("d"), P("d")),
                          out_specs=(P("d"), P("d"))))
err = stack([comp.init_error(T(S.grads(100 + r))) for r in range(S.RANKS)])
for i in range(S.ROUNDS):
    g = stack([T(S.grads(100 * (i + 1) + r)) for r in range(S.RANKS)])
    mean, err = f(g, err)
    res.update(S.flat(jax.tree.map(np.asarray, mean), f"psum/{{i}}/mean/"))
    res.update(S.flat(jax.tree.map(np.asarray, err), f"psum/{{i}}/e/"))
""", env={"XLA_FLAGS": f"--xla_force_host_platform_device_count={RANKS}"})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, "compression", RANKS, """
import sys
sys.path.insert(0, "tests")
import test_torch_compression as S
from repro_torch.distributed import compression as comp

psum_c = comp.make_compressed_psum()
err = comp.init_error(S.to_torch(S.grads(100 + rank)))
for i in range(S.ROUNDS):
    mean, err = psum_c(S.to_torch(S.grads(100 * (i + 1) + rank)), err)
    res.update(S.flat(mean, f"psum/{i}/mean/"))
    res.update(S.flat(err, f"psum/{i}/e/"))
""")


def _bits_equal(got, want, label):
    assert got.dtype == want.dtype == np.float32, (label, got.dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                  err_msg=label)


def test_roundtrip_matches_reference_bit_for_bit(reference):
    """Three rounds of quantize-dequantize with error feedback: every
    dequantized gradient and residual equal to the reference's, bit for
    bit."""
    err = comp.init_error(to_torch(grads(0)))
    for i in range(3):
        g_hat, err = comp.compress_roundtrip(to_torch(grads(i)), err)
        for name, tree in (("g", g_hat), ("e", err)):
            for k, v in flat(tree).items():
                _bits_equal(v, reference[f"roundtrip/{i}/{name}/{k}"],
                            f"round {i} {name} {k}")


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_compressed_psum_matches_reference_on_8_ranks(reference, ranks, rnd):
    """Every rank's mean and new residual equal the reference's for that
    device, bit for bit; the mean is the same on every rank."""
    for r, res in enumerate(ranks):
        for key, got in res.items():
            if not key.startswith(f"psum/{rnd}/"):
                continue
            _bits_equal(got, reference[key][r], f"rank {r} {key}")
            if "/mean/" in key:
                _bits_equal(got, ranks[0][key], f"rank {r} {key}")
    assert any(k.startswith(f"psum/{rnd}/mean/") for k in ranks[0])


def test_compression_roundtrip_error_bounded():
    """The reference's test: the error at most half a step of the int8
    grid, and the residual exactly the quantization error."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32))}
    e = comp.init_error(g)
    g_hat, e2 = comp.compress_roundtrip(g, e)
    err = float((g_hat["w"] - g["w"]).abs().max())
    scale = float(g["w"].abs().max()) / 127.0
    assert err <= scale * 0.5 + 1e-7
    np.testing.assert_allclose(e2["w"].numpy(), (g["w"] - g_hat["w"]).numpy(),
                               rtol=1e-6)


def test_compression_error_feedback_converges():
    """The reference's test: over 50 steps the sum of the dequantized
    gradients tracks the true sum (the error-feedback property)."""
    rng = np.random.default_rng(1)
    true = torch.from_numpy((rng.standard_normal(128) * 1e-3).astype(
        np.float32))
    e = {"w": torch.zeros(128)}
    acc = torch.zeros(128)
    for _ in range(50):
        g_hat, e = comp.compress_roundtrip({"w": true}, e)
        acc = acc + g_hat["w"]
    np.testing.assert_allclose(acc.numpy(), (true * 50).numpy(), rtol=0.02,
                               atol=1e-4)


def test_quantize_rounds_half_to_even():
    """``torch.round`` rounds half to even, as ``jnp.round``; the int8 grid
    clips at +-127."""
    q = comp.quantize(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 300.0,
                                    -300.0]), torch.tensor(1.0))
    assert q.tolist() == [0, 2, 2, 0, -2, 127, -127]
    assert q.dtype == torch.int8
