"""Content-addressed result cache for the placement service, as in the
reference package.

A cache entry holds the resolved placement plus the bit-exact simulated
cycle count and stat counters for one
:func:`repro_torch.service.hashing.query_key`. Because the whole pipeline is
bit-deterministic, serving an entry is indistinguishable from re-running
the query — zero simulations, same integers.

In memory the cache is a bounded LRU; pass ``directory=`` (or set
``$REPRO_SERVICE_CACHE``) to also persist entries as ``q<key>.npz`` files,
published with the graph cache's unique-tempfile + ``os.replace`` idiom
(:func:`repro_torch.core.workloads.save_graph`). The entry format and the
default directory are the reference's, so an entry either package writes
loads in the other. Counters (hits / misses / evictions / disk hits)
surface through :meth:`ResultCache.report`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import numpy as np


def service_cache_dir() -> str:
    """``$REPRO_SERVICE_CACHE`` or ``./experiments/service_cache``."""
    return os.environ.get(
        "REPRO_SERVICE_CACHE",
        os.path.join(os.getcwd(), "experiments", "service_cache"))


@dataclasses.dataclass(frozen=True, eq=False)
class CachedResult:
    """One answered query: placement + bit-exact result integers."""

    key: int                    # canonical query key (hashing.query_key)
    node_pe: np.ndarray         # [N] int32 node -> PE
    objective: str              # "cycles" | "cost"
    cycles: int | None          # simulated cycles (None for cost-only)
    cost: int | None            # integer placement-model cost (None = n/a)
    stats: dict                 # int stat counters from the SimResult


def _entry_path(directory: str, key: int) -> str:
    # Zero-padded unsigned hex so filenames are fixed-width and sortable.
    return os.path.join(directory, f"q{key & 0xFFFFFFFFFFFFFFFF:016x}.npz")


def _save_entry(path: str, entry: CachedResult) -> None:
    import tempfile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {"key": int(entry.key), "objective": entry.objective,
            "cycles": entry.cycles, "cost": entry.cost,
            "stats": {k: int(v) for k, v in entry.stats.items()}}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, node_pe=entry.node_pe,
                                meta=np.str_(json.dumps(meta)))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_entry(path: str) -> CachedResult:
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        return CachedResult(
            key=int(meta["key"]), node_pe=z["node_pe"].astype(np.int32),
            objective=meta["objective"], cycles=meta["cycles"],
            cost=meta["cost"],
            stats={k: int(v) for k, v in meta["stats"].items()})


class ResultCache:
    """Bounded LRU of :class:`CachedResult`, optionally disk-backed."""

    def __init__(self, capacity: int = 4096,
                 directory: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.directory = directory
        self._mem: OrderedDict[int, CachedResult] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0

    def __len__(self) -> int:
        return len(self._mem)

    def get(self, key: int) -> CachedResult | None:
        entry = self._mem.get(key)
        if entry is not None:
            self._mem.move_to_end(key)
            self.hits += 1
            return entry
        if self.directory is not None:
            path = _entry_path(self.directory, key)
            if os.path.exists(path):
                entry = _load_entry(path)
                self.disk_hits += 1
                self.hits += 1
                self._admit(key, entry)
                return entry
        self.misses += 1
        return None

    def put(self, key: int, entry: CachedResult) -> None:
        self._admit(key, entry)
        if self.directory is not None:
            _save_entry(_entry_path(self.directory, key), entry)

    def _admit(self, key: int, entry: CachedResult) -> None:
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.evictions += 1

    def report(self) -> dict:
        """Counter summary (all exact integers, and the hit rate)."""
        lookups = self.hits + self.misses
        return {
            "entries": len(self._mem),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "disk_hits": self.disk_hits,
            "hit_rate": round(self.hits / lookups, 4) if lookups else 0.0,
        }
