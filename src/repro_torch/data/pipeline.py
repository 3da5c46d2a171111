"""Deterministic, host-sharded data pipeline: a copy of the reference
package's ``data/pipeline.py`` (numpy only; the port imports none of the
reference), which gives the same batches bit for bit.

Sources:
  * SyntheticCopyTask — sequences whose second half repeats the first
    (learnable by attention, SSM and hybrid models alike); used by the
    loss-decrease tests and the e2e training example.
  * SyntheticZipfLM — zipf-distributed token soup (throughput benchmarking).
  * MemmapCorpus — np.memmap token file for real corpora.

Every batch is a function of (seed, step, host), so restarts resume the
stream exactly (checkpoint stores the step) and each host reads only its
shard of the global batch — no coordination needed at 1000-node scale.
A small prefetch thread hides host-side generation latency.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticCopyTask:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0):
        assert batch % num_hosts == 0
        self.vocab, self.seq, self.seed = vocab, seq, seed
        self.local_batch = batch // num_hosts
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        half = (self.seq + 1) // 2
        prefix = rng.integers(2, self.vocab, (self.local_batch, half), dtype=np.int32)
        full = np.concatenate([prefix, prefix], axis=1)[:, : self.seq + 1]
        full[:, half] = 1  # SEP
        tokens, labels = full[:, :-1], full[:, 1:]
        mask = np.zeros_like(labels, dtype=np.float32)
        mask[:, half:] = 1.0  # only the copied half is scored
        return {"tokens": tokens, "labels": labels.astype(np.int32), "mask": mask}


class SyntheticZipfLM:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0, alpha: float = 1.2):
        assert batch % num_hosts == 0
        self.vocab, self.seq, self.seed, self.alpha = vocab, seq, seed, alpha
        self.local_batch = batch // num_hosts
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        z = rng.zipf(self.alpha, (self.local_batch, self.seq + 1))
        toks = (np.minimum(z, self.vocab - 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapCorpus:
    """Flat token file (uint16/uint32). Sampling is deterministic in step."""

    def __init__(self, path: str, dtype, vocab: int, batch: int, seq: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.seq, self.seed = vocab, seq, seed
        self.local_batch = batch // num_hosts
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        hi = len(self.data) - self.seq - 1
        starts = rng.integers(0, hi, self.local_batch)
        rows = np.stack([self.data[s : s + self.seq + 1] for s in starts]).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Background-thread prefetch over ``dataset.batch_at(step)``."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.dataset.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
