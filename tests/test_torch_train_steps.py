"""The port's loss, optimizer, schedules and train step against the
reference's (12g.2-12g.4), on the CPU.

One reference subprocess computes, from numpy seeds:
  * ``chunked_softmax_xent`` on the reference's own cases
    (``tests/test_train.py``: a mask and a ragged last chunk; a padded
    vocabulary cut by ``valid_vocab``), and with ``z_loss`` and no mask:
    the loss, its metrics and the gradients of h and the head;
  * one ``AdamW`` step on given float32 gradients (with master weights and
    a WSD schedule; without master weights, clipped), and the schedules'
    values at every step of a range;
  * three train steps of the qwen2-0.5b and deepseek-v2-lite-16b smoke
    configs from the numpy recipe's weights, a fourth from the state the
    third left (handed to the port through
    ``convert.train_state_from_numpy``), and one step with
    ``grad_accum=2``.
Tolerances (float32): the loss 1e-6 relative, its gradients 1e-5; an
AdamW step 1e-6 (its rounding may differ by an ulp where XLA fuses a
multiply and an add); the schedules 3e-7 relative (two float32 ulps: the
libraries' cos and pow may round apart); train states as
``_assert_state`` states them. The reference's own test cases (the loss
falls on the copy task; accumulation is close to the full batch) run on
the port with the reference's thresholds.
"""
import numpy as np
import pytest
import torch

from _torch_ref import run_reference
from _torch_train import flat
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticCopyTask, SyntheticZipfLM
from repro_torch.optim import AdamW, cosine_schedule, wsd_schedule
from repro_torch.train.losses import chunked_softmax_xent
from repro_torch.train.steps import init_train_state, make_train_step

#: name: (b, t, d, v, chunk, masked, valid_vocab, z_loss)
XENT = {"mask_ragged_chunk": (2, 17, 8, 11, 5, True, None, 0.0),
        "padded_vocab": (1, 8, 4, 10, 4, False, 6, 0.0),
        "z_loss_no_mask": (2, 9, 8, 12, 4, False, None, 1e-2)}
SCHEDULES = {"wsd": ("wsd_schedule", (1.0, 10, 20, 10), dict(final_frac=0.1)),
             "wsd_lr": ("wsd_schedule", (3e-3, 4, 12, 4), {}),
             "cosine": ("cosine_schedule", (1.0, 5, 50), {})}
#: name: (WSD schedule's arguments or a constant lr, AdamW's options)
ADAMW = {"master_wsd": ((3e-3, 1, 5, 2),
                        dict(weight_decay=0.1, master_weights=True)),
         "clipped_no_master": (1e-2, dict(weight_decay=0.01,
                                          master_weights=False, b2=0.99))}
#: The train steps' AdamW: a WSD schedule's arguments and the decay.
STEP_OPT = ((1e-2, 2, 10, 3), dict(weight_decay=0.01))
STEP_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")
STEPS = 3
ACCUM_ARCH = "minicpm-2b"


def xent_inputs(case):
    b, t, d, v, *_ = XENT[case]
    rng = np.random.default_rng(sorted(XENT).index(case))
    return (rng.standard_normal((b, t, d), dtype=np.float32),
            rng.standard_normal((d, v), dtype=np.float32),
            rng.integers(0, XENT[case][6] or v, (b, t)).astype(np.int32),
            rng.integers(0, 2, (b, t)).astype(np.float32))


def adamw_inputs(name, cfg):
    """The smoke qwen2's weights and float32 gradients (x 30 where the
    step clips them)."""
    tree = convert.numpy_lm_params(cfg, 0)
    rng = np.random.default_rng(5)
    scale = 30.0 if name.startswith("clipped") else 0.01
    return tree, convert._map_tree(
        lambda x: (rng.standard_normal(x.shape, dtype=np.float32)
                   * np.float32(scale)), tree)


def optimizer(adamw, wsd, lr, kw):
    """``adamw`` (the reference's class or the port's) with ``lr`` a WSD
    schedule (``wsd``) of those arguments, or a constant."""
    return adamw(lr=wsd(*lr) if isinstance(lr, tuple) else lr, **kw)


def step_batches(cfg):
    ds = SyntheticCopyTask(cfg.vocab_size, batch=4, seq=16, seed=0)
    return [ds.batch_at(i) for i in range(STEPS + 1)]


def accum_batch(cfg):
    return SyntheticZipfLM(cfg.vocab_size, batch=8, seq=16, seed=0).batch_at(0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "train_steps", """
import sys
sys.path.insert(0, "tests")
import jax.numpy as jnp
import _torch_train as T
import test_torch_train_steps as S
from repro.configs import get_config
from repro.optim import AdamW, cosine_schedule, wsd_schedule
from repro.optim import schedule as ref_schedule
from repro.train.losses import chunked_softmax_xent
from repro.train.steps import make_train_step
from repro_torch.configs import get_config as port_config
from repro_torch.convert import numpy_lm_params

for case, (b, t, d, v, chunk, masked, vv, z) in S.XENT.items():
    h, head, labels, mask = (jnp.asarray(a) for a in S.xent_inputs(case))
    f = lambda h, head: chunked_softmax_xent(
        h, head, labels, mask if masked else None, chunk=chunk, z_loss=z,
        valid_vocab=vv)
    (loss, m), (gh, ghead) = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(h, head)
    res.update({f"xent/{case}/loss": loss, f"xent/{case}/dh": gh,
                f"xent/{case}/dhead": ghead})
    res.update({f"xent/{case}/{k}": x for k, x in m.items()})

for name, (fn, args, kw) in S.SCHEDULES.items():
    lr = getattr(ref_schedule, fn)(*args, **kw)
    res[f"schedule/{name}"] = np.array([np.asarray(lr(i)) for i in range(64)])

cfg = port_config("qwen2-0.5b", smoke=True)
for name, args in S.ADAMW.items():
    tree, grads = S.adamw_inputs(name, cfg)
    opt = S.optimizer(AdamW, wsd_schedule, *args)
    params = jax.tree.map(jnp.asarray, tree)
    st = opt.init(params)
    for step in range(2):
        params, st, om = opt.update(jax.tree.map(jnp.asarray, grads), st,
                                    params)
        res.update(T.flat({"params": params, "opt": st, **om},
                          f"adamw/{name}/{step}/"))


def run_steps(arch, state, batches, key):
    rcfg = get_config(arch, smoke=True)
    step = jax.jit(make_train_step(rcfg, S.optimizer(AdamW, wsd_schedule,
                                                     *S.STEP_OPT)))
    for i, batch in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        res.update(T.flat(m, f"{key}/metrics/{i}/"))
    return state

for arch in S.STEP_ARCHS:
    pcfg = port_config(arch, smoke=True)
    opt = S.optimizer(AdamW, wsd_schedule, *S.STEP_OPT)
    params = jax.tree.map(jnp.asarray, numpy_lm_params(pcfg, 0))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    batches = S.step_batches(pcfg)
    state = run_steps(arch, state, batches[:S.STEPS], f"steps/{arch}")
    res.update(T.flat(state, f"steps/{arch}/state/"))
    state = run_steps(arch, state, batches[S.STEPS:], f"resumed/{arch}")
    res.update(T.flat(state, f"resumed/{arch}/state/"))

rcfg = get_config(S.ACCUM_ARCH, smoke=True)
opt = AdamW(lr=1e-3, master_weights=False)
params = jax.tree.map(jnp.asarray,
                      numpy_lm_params(port_config(S.ACCUM_ARCH, smoke=True), 0))
batch = {k: jnp.asarray(v) for k, v in S.accum_batch(rcfg).items()}
for ga in (1, 2):
    st = {"params": params, "opt": opt.init(params),
          "step": jnp.zeros((), jnp.int32)}
    st, m = jax.jit(make_train_step(rcfg, opt, grad_accum=ga))(st, batch)
    res.update(T.flat({"params": st["params"], **m}, f"accum/{ga}/"))
""")


def _close_tree(got: dict, want: dict, prefix: str, *, atol=0.0, scale=0.0,
                rtol=0.0):
    """Every leaf of ``want`` under ``prefix`` (flat keys) against ``got``:
    |got - want| <= atol + scale * max|want leaf| + rtol * |want|."""
    keys = {k[len(prefix):] for k in want if k.startswith(prefix)}
    assert keys == set(got), set(got) ^ keys
    bad = []
    for k in sorted(keys):
        w = want[prefix + k]
        bound = atol + scale * np.abs(w).max() + rtol * np.abs(w)
        err = np.abs(got[k] - w)
        if not (err <= bound).all():
            i = np.argmax(err - bound)
            bad.append(f"{k}: {err.ravel()[i]:.3e} at |want| "
                       f"{np.abs(w).ravel()[i]:.3e}, scale {np.abs(w).max():.3e}")
    assert not bad, f"{prefix}: " + "; ".join(bad)


@pytest.mark.parametrize("case", sorted(XENT))
def test_chunked_xent_matches_reference(reference, case):
    _, _, _, _, chunk, masked, vv, z = XENT[case]
    h, head, labels, mask = (torch.from_numpy(a) for a in xent_inputs(case))
    h.requires_grad_()
    head.requires_grad_()
    loss, m = chunked_softmax_xent(h, head, labels, mask if masked else None,
                                   chunk=chunk, z_loss=z, valid_vocab=vv)
    gh, ghead = torch.autograd.grad(loss, (h, head))
    key = f"xent/{case}/"
    np.testing.assert_allclose(loss.item(), reference[key + "loss"],
                               rtol=1e-6)
    for k in ("xent", "accuracy", "tokens"):
        np.testing.assert_allclose(m[k].item(), reference[key + k], rtol=1e-6)
    for got, name in ((gh, "dh"), (ghead, "dhead")):
        np.testing.assert_allclose(got.numpy(), reference[key + name],
                                   rtol=1e-5, atol=1e-7)


def test_chunked_xent_matches_direct():
    """The reference's oracle test: the masked mean of the direct
    log-softmax's negative log-likelihood (1e-5)."""
    h, head, labels, mask = (torch.from_numpy(a)
                             for a in xent_inputs("mask_ragged_chunk"))
    loss, _ = chunked_softmax_xent(h, head, labels, mask, chunk=5)
    logp = torch.log_softmax(h @ head, -1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    want = (nll * mask).sum() / mask.sum()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-5)


def test_chunked_xent_padded_vocab_mask():
    h, head, labels, _ = (torch.from_numpy(a)
                          for a in xent_inputs("padded_vocab"))
    loss_p, _ = chunked_softmax_xent(h, head, labels, chunk=4, valid_vocab=6)
    loss_ref, _ = chunked_softmax_xent(h, head[:, :6], labels, chunk=4)
    np.testing.assert_allclose(loss_p.item(), loss_ref.item(), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(reference, name):
    import repro_torch.optim.schedule as sched
    fn, args, kw = SCHEDULES[name]
    lr = getattr(sched, fn)(*args, **kw)
    got = np.array([lr(i).item() for i in range(64)], np.float32)
    np.testing.assert_allclose(got, reference[f"schedule/{name}"], rtol=3e-7,
                               atol=0)
    assert lr(torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


def test_wsd_schedule_phases():
    lr = wsd_schedule(1.0, warmup=10, stable=20, decay=10, final_frac=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(5)) == pytest.approx(0.5)
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(25)) == pytest.approx(1.0)
    assert float(lr(40)) == pytest.approx(0.1, rel=1e-3)
    lrc = cosine_schedule(1.0, warmup=5, total=50)
    assert float(lrc(5)) == pytest.approx(1.0)
    assert float(lrc(50)) == pytest.approx(0.1, rel=1e-2)


def test_adamw_step_matches_manual():
    opt = AdamW(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                clip_norm=1e9, master_weights=True)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    st = opt.init(p)
    newp, st, m = opt.update(g, st, {k: v.clone() for k, v in p.items()})
    mm = 0.1 * 0.5
    vv = 0.01 * 0.25
    upd = (mm / (1 - 0.9)) / (np.sqrt(vv / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), p["w"].numpy() - 0.1 * upd,
                               rtol=1e-6)


def test_grad_clip():
    opt = AdamW(lr=0.0, clip_norm=1.0, master_weights=False, weight_decay=0.0)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    st = opt.init(p)
    _, _, m = opt.update(g, st, p)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


@pytest.mark.parametrize("name", sorted(ADAMW))
def test_adamw_matches_reference(reference, name):
    """Two AdamW steps on the same float32 gradients from the smoke qwen2's
    weights: the parameters, m, v, the master weights, count, grad_norm and
    lr within 1e-6 (relative, and absolute of each leaf's scale)."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    tree, grads = adamw_inputs(name, cfg)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    opt = optimizer(AdamW, wsd_schedule, *ADAMW[name])
    st = opt.init(model)
    named_grads = {n: torch.from_numpy(np.ascontiguousarray(g)) for n, g in
                   convert._named_leaves(cfg, grads)}
    for step in range(2):
        _, st, om = opt.update(named_grads, st, model)
        got = flat({"params": convert.lm_params_to_numpy(model),
                    "opt": {k: (convert.named_to_numpy(cfg, v)
                                if isinstance(v, dict) else v.numpy())
                            for k, v in st.items()},
                    **{k: v.numpy() for k, v in om.items()}})
        _close_tree(got, reference, f"adamw/{name}/{step}/", rtol=1e-6,
                    scale=1e-6)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 2


def _port_state(cfg, tree):
    """The reference's fresh train state from the weights ``tree``, through
    ``convert.train_state_from_numpy``."""
    zeros = convert._map_tree(np.zeros_like, tree)
    return convert.train_state_from_numpy(cfg, {
        "params": tree, "opt": {"m": zeros, "v": zeros, "master": tree,
                                "count": np.int32(0)},
        "step": np.int32(0)}, device="cpu")


def _metrics(m):
    return {k: np.asarray(v.item(), np.float32) for k, v in m.items()}


def _quantile_close(got, want, prefix, bound, q_bound, q=0.999):
    """Every element within ``bound`` and a fraction ``q`` of them within
    ``q_bound``; each bound is a function of the leaf."""
    for k, w in want.items():
        err = np.abs(got[k[len(prefix):]] - w)
        assert err.max() <= bound(w), f"{k}: {err.max():.3e}"
        assert np.quantile(err, q) <= q_bound(w), f"{k}: {np.quantile(err, q):.3e}"


def _assert_state(got_state, reference, prefix, lr_sum=None):
    """The port's train state against the reference's at ``prefix``: count
    and step equal. One step from the same state (``lr_sum`` None): the
    parameters and master weights within 2e-6, the moments within 1e-5 of
    each leaf's scale. Steps from the same weights (``lr_sum``, the sum of
    the learning rates applied): Adam turns the ~1e-6 by which the two
    sides' gradients round apart into updates of up to ~lr either way
    where a moment is near zero, so the parameters and master weights are
    held within 2e-2 x ``lr_sum`` everywhere and 1e-3 x ``lr_sum`` at
    99.9% of the elements; the moments within 5e-4 of each leaf's scale
    everywhere, 1e-4 at 99.9%."""
    got = flat(convert.train_state_to_numpy(got_state))
    want = {k: v for k, v in reference.items() if k.startswith(prefix)}
    assert {k[len(prefix):] for k in want} == set(got)
    for k in ("opt/count", "step"):
        assert got[k] == want[prefix + k], k
    weights = {k: v for k, v in want.items()
               if k.startswith((prefix + "params/", prefix + "opt/master/"))}
    moments = {k: v for k, v in want.items()
               if k.startswith((prefix + "opt/m/", prefix + "opt/v/"))}
    if lr_sum is None:
        _quantile_close(got, weights, prefix, lambda w: 2e-6, lambda w: 2e-6)
        _quantile_close(got, moments, prefix,
                        lambda w: 1e-5 * np.abs(w).max(),
                        lambda w: 1e-5 * np.abs(w).max())
    else:
        _quantile_close(got, weights, prefix, lambda w: 2e-2 * lr_sum,
                        lambda w: 1e-3 * lr_sum)
        _quantile_close(got, moments, prefix,
                        lambda w: 5e-4 * np.abs(w).max(),
                        lambda w: 1e-4 * np.abs(w).max())


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(reference, arch):
    """Three steps from the numpy recipe's weights: each step's metrics
    (5e-5 relative: a step's gradient norm moves with the parameters'
    differences) and the state after them; then a fourth step from the
    reference's own state after three, handed over as numpy (metrics 5e-6
    relative, the state as one step's)."""
    cfg = get_config(arch, smoke=True)
    step = make_train_step(cfg, optimizer(AdamW, wsd_schedule, *STEP_OPT))
    batches = step_batches(cfg)
    state = _port_state(cfg, convert.numpy_lm_params(cfg, 0))
    for i, batch in enumerate(batches[:STEPS]):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        _close_tree(_metrics(m), reference, f"steps/{arch}/metrics/{i}/",
                    rtol=5e-5, atol=1e-7)
    lr = wsd_schedule(*STEP_OPT[0])
    _assert_state(state, reference, f"steps/{arch}/state/",
                  lr_sum=sum(float(lr(c)) for c in range(1, STEPS + 1)))
    handed = {}
    for k, v in reference.items():
        if k.startswith(f"steps/{arch}/state/"):
            handed[k[len(f"steps/{arch}/state/"):]] = v
    tree = _unflat(handed)
    state = convert.train_state_from_numpy(cfg, tree, device="cpu")
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batches[STEPS].items()})
    _close_tree(_metrics(m), reference, f"resumed/{arch}/metrics/0/",
                rtol=5e-6, atol=1e-7)
    _assert_state(state, reference, f"resumed/{arch}/state/")


def _unflat(flat_tree: dict) -> dict:
    """Flat ``a/b/0/c`` keys -> nested dicts, with lists where the keys
    are indices (``None`` at missing ones: the hybrid's shared segments)."""
    out: dict = {}
    for key, v in flat_tree.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            n = max(map(int, node)) + 1
            return [lists(node.get(str(i))) for i in range(n)]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def test_grad_accum_matches_reference_and_full_batch(reference):
    """``grad_accum=2`` against the full batch at the reference test's
    thresholds (loss 1e-4 relative, parameters 2e-3 relative + 2e-5), and
    each against the reference's own: the loss 1e-6 relative, the
    parameters 2e-2 of the step's lr 1e-3 (as ``_assert_state``)."""
    cfg = get_config(ACCUM_ARCH, smoke=True)
    opt = AdamW(lr=1e-3, master_weights=False)
    batch = {k: torch.from_numpy(v) for k, v in accum_batch(cfg).items()}
    out = {}
    for ga in (1, 2):
        model = convert.lm_params_from_numpy(
            cfg, convert.numpy_lm_params(cfg, 0), device="cpu")
        model.requires_grad_(True)
        st = {"params": model, "opt": opt.init(model),
              "step": torch.zeros((), dtype=torch.int32)}
        st, m = make_train_step(cfg, opt, grad_accum=ga)(st, batch)
        assert set(m) == ({"loss", "grad_norm", "lr"} if ga == 2 else
                          {"loss", "grad_norm", "lr", "xent", "accuracy",
                           "tokens", "moe_aux", "moe_dropped"})
        got = flat({"params": convert.lm_params_to_numpy(st["params"]),
                    "loss": m["loss"].numpy()})
        _close_tree(got, {k: v for k, v in reference.items()
                          if k.startswith((f"accum/{ga}/params/",
                                           f"accum/{ga}/loss"))},
                    f"accum/{ga}/", atol=2e-2 * 1e-3, rtol=1e-6)
        out[ga] = got
    np.testing.assert_allclose(out[1]["loss"], out[2]["loss"], rtol=1e-4)
    for k in out[1]:
        np.testing.assert_allclose(out[1][k], out[2][k], rtol=2e-3, atol=2e-5)


def test_loss_decreases_quickly():
    """The reference's test: 60 steps of the copy task on the qwen2 smoke
    config from random weights; the mean of the last 5 losses below 0.9
    of the first 5's."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    opt = AdamW(lr=wsd_schedule(1e-2, 10, 1000, 100), weight_decay=0.01)
    state = init_train_state(torch.Generator("cpu").manual_seed(0), cfg, opt)
    step = make_train_step(cfg, opt)
    ds = SyntheticCopyTask(cfg.vocab_size, batch=16, seq=32, seed=0)
    losses = []
    for i in range(60):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in ds.batch_at(i).items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9
    assert int(state["step"]) == 60 and int(state["opt"]["count"]) == 60
