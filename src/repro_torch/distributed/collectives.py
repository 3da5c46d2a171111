"""Collective traffic of a step: the counterpart of the reference package's
``distributed/hlo.py``.

The reference parses the collectives out of XLA's optimized HLO text. The
port has no HLO: its collectives are the ones
:mod:`repro_torch.distributed.sharding` issues, each of which leaves a
record ``(kind, result bytes, group size S)`` in ``sharding.records``.
Per-rank traffic uses the reference's ring-algorithm model:

    all-reduce          2 * B * (S-1)/S      (reduce-scatter + all-gather)
    all-gather          B * (S-1)/S          (B = full result bytes)
    reduce-scatter      B * (S-1)            (B = shard result bytes)
    all-to-all          B * (S-1)/S
    collective-permute  B
"""
from __future__ import annotations

from collections import defaultdict

import torch

#: Bytes an element of each dtype takes.
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.float16: 2, torch.bfloat16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _traffic(kind: str, result_bytes: int, s: int) -> float:
    if s <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (s - 1) / s
    if kind == "all-gather":
        return result_bytes * (s - 1) / s
    if kind == "reduce-scatter":
        return result_bytes * (s - 1)
    if kind == "all-to-all":
        return result_bytes * (s - 1) / s
    return float(result_bytes)  # collective-permute


def collective_bytes(records) -> dict:
    """Per-rank collective stats of ``records`` (``(kind, result bytes,
    group size)`` each, as ``sharding.records`` holds them).

    Returns {kind: {bytes, traffic_bytes, count}, total_bytes, total_traffic,
    total_count}: the reference's keys; ``bytes`` = result bytes,
    ``traffic_bytes`` = ring-model bytes per rank (the roofline's collective
    term).
    """
    out: dict = defaultdict(lambda: {"bytes": 0, "traffic_bytes": 0.0,
                                     "count": 0})
    for kind, nbytes, s in records:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind]["bytes"] += int(nbytes)
        out[kind]["traffic_bytes"] += _traffic(kind, int(nbytes), int(s))
        out[kind]["count"] += 1
    result = {k: dict(v) for k, v in out.items()}
    result["total_bytes"] = int(sum(v["bytes"] for v in out.values()))
    result["total_traffic"] = float(sum(v["traffic_bytes"]
                                        for v in out.values()))
    result["total_count"] = int(sum(v["count"] for v in out.values()))
    return result
