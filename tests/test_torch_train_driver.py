"""The port's training driver (``python -m repro_torch.launch.train``) and
mesh builders on the CPU: a run with ``--sim-fail`` crashes after its
checkpoint and a restart resumes it to the uninterrupted run's parameters
bit for bit; SIGTERM checkpoints and stops; without a card and without
``--device cpu`` it raises; the sharded options: ``--distributed`` (a
gloo world of one from the launcher's environment, a 1x1 mesh) trains to
the local run's state bit for bit, ``--mesh single|multi`` on a world of
one fail naming the world size they need; the log line;
``make_local_mesh`` over a one-rank gloo group, and without a card and
without ``device_type`` it raises.
"""
import os
import signal

import numpy as np
import pytest
import torch

from _torch_ref import one_rank_mesh
from _torch_train import flat
from repro_torch import convert
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train

ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--batch", "4",
        "--seq", "16", "--lr", "1e-2", "--warmup", "2", "--log-every", "100"]


def _params(state):
    return {n: p.detach().clone() for n, p in
            state["params"].named_parameters()}


def test_sim_fail_then_restart_resumes_exactly(tmp_path, capsys):
    want = _params(train.main(ARGS + ["--steps", "8"]))
    ckpt = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="sim-fail"):
        train.main(ARGS + ["--steps", "8", "--ckpt", ckpt, "--sim-fail", "5"])
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000005"]
    state = train.main(ARGS + ["--steps", "8", "--ckpt", ckpt])
    assert "[resume] restored step 5" in capsys.readouterr().out
    assert int(state["step"]) == 8 and int(state["opt"]["count"]) == 8
    got = _params(state)
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_sigterm_checkpoints_and_stops(tmp_path):
    ckpt = str(tmp_path / "run")
    before = signal.getsignal(signal.SIGTERM)

    def on_step(step, state, metrics):
        assert torch.isfinite(metrics["loss"])
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    state = train.main(ARGS + ["--steps", "50", "--ckpt", ckpt,
                               "--ckpt-every", "100"], on_step=on_step)
    assert int(state["step"]) == 3
    assert (tmp_path / "run" / "LATEST").read_text() == "3"
    assert signal.getsignal(signal.SIGTERM) is before


def test_log_line(capsys):
    train.main(ARGS + ["--steps", "4", "--log-every", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2
    fields = lines[1].split()
    assert fields[:2] == ["step", "4"] and fields[2::2][:4] == [
        "loss", "gnorm", "lr", "tok/s"]


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args + ["--steps", "1"])


@pytest.mark.parametrize("extra", [["--mesh", "single"], ["--mesh", "multi"],
                                   ["--distributed"]])
def test_sharded_options_raise(extra, monkeypatch):
    """``--mesh single|multi`` need worlds of 256 and 512 ranks and fail on
    a world of one, naming the size; ``--distributed`` (``--mesh local``)
    joins the launcher's group, a gloo world of one (``MASTER_PORT`` 0:
    the store takes a free port), shards the state on a 1x1 mesh and
    trains to the local run's state bit for bit, leaving no group."""
    import torch.distributed as dist

    from repro_torch.train import sharded

    if extra[0] == "--mesh":
        size = 256 if extra[1] == "single" else 512
        with pytest.raises(RuntimeError,
                           match=f"needs a world size of {size}"):
            train.main(ARGS + ["--steps", "1"] + extra)
        return
    want = convert.train_state_to_numpy(train.main(ARGS + ["--steps", "3"]))
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    seen = {}

    def on_step(step, state, metrics):
        seen.update(sharded=sharded.is_sharded(state),
                    backend=dist.get_backend(),
                    mesh=tuple(state["params"].embed.device_mesh.shape))

    state = train.main(ARGS + ["--steps", "3"] + extra, on_step=on_step)
    assert seen == {"sharded": True, "backend": "gloo", "mesh": (1, 1)}
    assert not dist.is_initialized()
    got = convert.train_state_to_numpy(state)
    a, b = flat(got), flat(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_local_mesh_over_one_rank(tmp_path):
    """``make_local_mesh(1, 1)``: a 1x1 mesh with the reference's axis
    names over a gloo group of one; the production meshes need 256 or 512
    ranks and refuse a world of one."""
    import torch.distributed as dist

    with one_rank_mesh(tmp_path):
        mesh = mesh_mod.make_local_mesh(1, 1, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        for multi in (False, True):
            with pytest.raises(RuntimeError, match="world size"):
                mesh_mod.make_production_mesh(multi_pod=multi,
                                              device_type="cpu")
    assert not dist.is_initialized()


def test_local_mesh_needs_a_card_or_a_device_type(monkeypatch):
    """With no ``device_type`` a mesh is the card's: without one it raises
    in ``resolve_device``'s words, before any process group is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mesh_mod.make_local_mesh, mesh_mod.make_production_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

