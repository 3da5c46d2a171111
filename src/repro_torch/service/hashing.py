"""Process-stable content-hash keys for the placement service cache, as in
the reference package (the same text, the same digests, the same keys).

A query is identified by what it *means*, not by object identity: the raw
:class:`~repro_torch.core.graph.DataflowGraph` tables, the PE grid, the
canonical :class:`~repro_torch.place.spec.PlacementSpec`, the model knobs of
the :class:`~repro_torch.core.overlay.OverlayConfig`, and the query
objective, all fed through BLAKE2b. Python's randomized ``hash()`` is never
involved, so keys survive ``PYTHONHASHSEED`` and name on-disk cache entries
that either package can read.

Execution-only knobs are deliberately EXCLUDED from the key: ``engine`` and
``check_every`` pick *how* a chunk of cycles executes, never what it
computes (all engines give the same bits), so a result simulated under
``engine="megakernel"`` serves a later ``engine="select"`` query for the
same model. The port's ``PlacementSpec``, ``AnnealConfig`` and
``TelemetrySpec`` carry the reference's class names, field names and value
types, so a config encodes to the reference's text.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..place.spec import PlacementArray

#: OverlayConfig fields that change simulation *semantics* (cycle counts).
#: ``engine`` / ``check_every`` are execution strategy and excluded — see
#: the module docstring.
MODEL_KNOBS = ("scheduler", "select_latency", "eject_capacity", "max_cycles",
               "eject_policy", "placement", "telemetry")


def _update_array(h, tag: str, a) -> None:
    a = np.ascontiguousarray(a)
    h.update(tag.encode())
    h.update(str(a.dtype).encode())
    h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(a.tobytes())


def encode_value(v) -> str:
    """Canonical, process-stable string form of a config value.

    Dataclasses (PlacementSpec, AnnealConfig, TelemetrySpec, ...) encode as
    ``TypeName(field=..., ...)`` with fields sorted by name, recursively —
    declaration-order or dict-iteration accidents can't move the key.
    """
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        d = dataclasses.asdict(v)
        inner = ",".join(f"{k}={encode_value(d[k])}" for k in sorted(d))
        return f"{type(v).__name__}({inner})"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k}:{encode_value(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(encode_value(x) for x in v) + "]"
    if isinstance(v, float):
        return repr(float(v))
    return repr(v)


def config_token(cfg) -> str:
    """Canonical encoding of an OverlayConfig's model knobs.

    ``cfg.placement`` is already a canonical ``PlacementSpec`` (the config
    stores every spelling through :func:`repro_torch.place.spec.resolve`),
    so ``placement="anneal"`` and ``placement=PlacementSpec(strategy=
    "anneal")`` produce one token. An explicit ``[N]`` array (a
    :class:`~repro_torch.place.spec.PlacementArray`) has no key: the
    reference's configs cannot hold one, so it raises ``TypeError``.
    """
    if isinstance(cfg.placement, PlacementArray):
        raise TypeError(
            "the placement service keys a query by its PlacementSpec; an "
            "explicit node -> PE array has no key (pass a strategy name or "
            "a PlacementSpec)")
    return ";".join(f"{k}={encode_value(getattr(cfg, k))}"
                    for k in MODEL_KNOBS)


def graph_digest(g) -> bytes:
    """16-byte BLAKE2b digest of the DataflowGraph tables."""
    h = hashlib.blake2b(digest_size=16)
    _update_array(h, "opcode", g.opcode)
    _update_array(h, "fanout_ptr", g.fanout_ptr)
    _update_array(h, "fanout_dst", g.fanout_dst)
    _update_array(h, "fanout_slot", g.fanout_slot)
    _update_array(h, "initial_values", g.initial_values)
    return h.digest()


def query_digest(g, nx: int, ny: int, cfg, objective: str = "cycles") -> bytes:
    """16-byte digest of (graph tables, grid, model knobs, objective)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_digest(g))
    h.update(f"grid={int(nx)}x{int(ny)};obj={objective};".encode())
    h.update(config_token(cfg).encode())
    return h.digest()


def query_key(g, nx: int, ny: int, cfg, objective: str = "cycles") -> int:
    """Canonical int64 cache key (signed, from the digest's first 8 bytes)."""
    d = query_digest(g, nx, ny, cfg, objective)
    return int(np.frombuffer(d[:8], dtype="<i8")[0])
