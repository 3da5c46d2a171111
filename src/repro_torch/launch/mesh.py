"""Production mesh construction: the counterpart of the reference package's
``launch/mesh.py``, as a :class:`torch.distributed.device_mesh.DeviceMesh`
(the mesh type of :mod:`repro_torch.core.distributed`).

Functions, not module-level constants, so importing this module never
touches a process group. Single-pod: 16 x 16 = 256 ranks ``("data",
"model")``. Multi-pod: 2 x 16 x 16 = 512 ranks ``("pod", "data",
"model")``. A mesh needs an initialised process group whose world is the
mesh's size (``torch.distributed.init_process_group``, with its address,
world size and rank given); ``init_device_mesh`` raises otherwise.
"""
from __future__ import annotations


def _make_mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        import torch
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type=None):
    """A small ``("data", "model")`` mesh over the group's ranks
    (tests/smokes). ``device_type`` None: ``"cuda"`` where a card is
    available, else ``"cpu"``."""
    return _make_mesh((data, model), ("data", "model"), device_type)
