"""Elastic scaling: re-shard a train state onto a different mesh. The
counterpart of the reference package's ``distributed/elastic.py``.

Checkpoints hold whole host tensors (manifest-based), so elasticity reduces
to recomputing the specs for the NEW mesh and placing the state by them
(the checkpoint manager's restore into a template on the new mesh does it
for a restart). A data-parallel rescale keeps per-step semantics by holding
the GLOBAL batch fixed: every rank draws the same global batch and keeps
its rows, whatever the mesh (:func:`repro_torch.train.sharded.batch_rows`).

Failure handling follows the reference's policy: a failed job restarts on
the surviving mesh through the checkpoint's auto-resume
(``launch/train.py``), restoring onto that mesh.
"""
from __future__ import annotations

from .. import convert


def remesh(cfg, state, new_mesh):
    """A train state (one device, or sharded on any mesh) -> the same state
    placed on ``new_mesh`` by ``cfg``'s ``state_specs``, on the device the
    state lies on. Every rank of the old mesh and the new calls it: the
    whole state is gathered to the host in the reference's layout (as a
    checkpoint holds it), then each rank keeps its blocks."""
    device = next(state["params"].parameters()).device
    return convert.train_state_from_numpy(cfg, convert.train_state_tree(state),
                                          device, mesh=new_mesh)


def rescale_batch(global_batch: int, old_hosts: int, new_hosts: int) -> int:
    """Per-host batch after an elastic resize (global batch invariant)."""
    if global_batch % new_hosts:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{new_hosts} hosts")
    return global_batch // new_hosts
