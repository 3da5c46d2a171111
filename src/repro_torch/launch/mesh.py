"""Production mesh construction: the counterpart of the reference package's
``launch/mesh.py``, as a :class:`torch.distributed.device_mesh.DeviceMesh`
(the mesh type of :mod:`repro_torch.core.distributed` and
:mod:`repro_torch.distributed.sharding`).

Functions, not module-level constants, so importing this module never
touches a process group. Single-pod: 16 x 16 = 256 ranks ``("data",
"model")``. Multi-pod: 2 x 16 x 16 = 512 ranks ``("pod", "data",
"model")``. A mesh needs an initialised process group whose world is the
mesh's size (``torch.distributed.init_process_group``, with its address,
world size and rank given); on another world it raises, naming the size it
needs. ``device_type`` None means the CUDA card, and raises without one;
pass ``device_type="cpu"`` for a CPU mesh.

:func:`fake_production_mesh` makes the production mesh on a fake process
group of its size (the dry-run's: this process is rank 0, collectives move
nothing), and tears the group down after.
"""
from __future__ import annotations

import contextlib
import math

from ..api import resolve_device


def _make_mesh(shape, axes, device_type, what: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = resolve_device(None).type
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != size:
        hint = ("" if dist.is_initialized() else
                " (no process group: run each rank under a launcher with "
                "--distributed)")
        raise RuntimeError(f"the {what} mesh {tuple(shape)} needs a world "
                           f"size of {size} ranks; this world size is "
                           f"{world}{hint}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type,
                      "multi-pod" if multi_pod else "single-pod")


def make_local_mesh(data: int = 1, model: int = 1, device_type=None):
    """A small ``("data", "model")`` mesh over the group's ranks
    (tests/smokes; the world must be ``data * model`` ranks).
    ``device_type`` None: the CUDA card (raises without one)."""
    return _make_mesh((data, model), ("data", "model"), device_type, "local")


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False, device_type=None):
    """:func:`make_production_mesh` on a fake process group (torch's
    ``fake`` backend) of 256 or 512 ranks, this process rank 0; the group is
    destroyed on exit. Refuses to run where a process group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: the fake production "
                           "mesh needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod,
                                   device_type=device_type)
    finally:
        dist.destroy_process_group()
