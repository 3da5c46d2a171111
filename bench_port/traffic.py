"""The one traffic generator of the benchmark. A traffic mix is a JSON file
``traffic/<name>.json`` of parameters; this module turns it, with a run's
seed, into the calls of a run:

* ``engine``: the port's engine every call runs under.
* ``calls``: the kinds of call, each one solo ``repro_torch.run`` call with
  a ``name``, the local-memory ``layout`` its graph memory is packed with
  (``"criticality"`` or ``"fifo"``), a ``scheduler`` and optionally a
  ``select_latency`` (left out: the policy's default).
* ``order``: ``"rounds"``, a closed loop with one client: round after round,
  each kind once a round in an order drawn from the seed, so every seed
  runs the same mix of work in another order.
* ``trace_calls``: the calls of each profiled slice of a traced run.
* ``value_sample``: how many calls, drawn from the seed, keep every node
  value for the comparison with the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np

#: Streams drawn from one run seed: call order, then the value sample.
ORDER_STREAM, SAMPLE_STREAM = 1, 2
LAYOUTS = ("criticality", "fifo")


@dataclasses.dataclass(frozen=True)
class CallKind:
    name: str
    layout: str
    scheduler: str
    select_latency: int | None


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def kinds(traffic: dict) -> list[CallKind]:
    out = []
    for c in traffic["calls"]:
        if c["layout"] not in LAYOUTS:
            raise ValueError(f"unknown layout {c['layout']!r}")
        out.append(CallKind(c["name"], c["layout"], c["scheduler"],
                            c.get("select_latency")))
    return out


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def order(traffic: dict, n_kinds: int, seed: int):
    """Endless kind indices of a run, drawn from ``seed``."""
    if traffic.get("order", "rounds") != "rounds":
        raise ValueError(f"unknown order {traffic['order']!r}")
    r = rng(seed, ORDER_STREAM)
    for _ in itertools.count():
        yield from r.permutation(n_kinds).tolist()


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = rng(seed, SAMPLE_STREAM)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
