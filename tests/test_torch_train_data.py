"""The port's data pipeline (``repro_torch.data.pipeline``, a numpy copy of
the reference's) against the reference's: every batch equal bit for bit,
dtypes included, for each source, step and host shard (``SeedSequence([seed,
step, host])``), and the prefetcher's stream equal to ``batch_at``.
"""
import numpy as np
import pytest

from _torch_ref import run_reference
from repro_torch.data.pipeline import (MemmapCorpus, Prefetcher,
                                       SyntheticCopyTask, SyntheticZipfLM)

#: (vocab, batch, seq, seed) of each source, the steps and the host shards.
SOURCES = {"copy": (100, 8, 16, 3), "copy_odd": (50, 6, 17, 1),
           "zipf": (1000, 8, 16, 0), "memmap": (65000, 8, 12, 4)}
STEPS = (0, 1, 7, 1234)
HOSTS = ((1, 0), (2, 0), (2, 1))
CORPUS = dict(size=5000, dtype="uint16", seed=9)


def make(cls_by_name, name, num_hosts, host_id, corpus):
    vocab, batch, seq, seed = SOURCES[name]
    kw = dict(batch=batch, seq=seq, seed=seed, num_hosts=num_hosts,
              host_id=host_id)
    if name == "memmap":
        return cls_by_name["MemmapCorpus"](corpus, CORPUS["dtype"], vocab, **kw)
    cls = cls_by_name["SyntheticZipfLM" if name == "zipf"
                      else "SyntheticCopyTask"]
    return cls(vocab, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "tokens.bin"
    rng = np.random.default_rng(CORPUS["seed"])
    rng.integers(0, 65000, CORPUS["size"]).astype(CORPUS["dtype"]).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, corpus):
    return run_reference(tmp_path_factory, "train_data", f"""
import sys
sys.path.insert(0, "tests")
import test_torch_train_data as D
from repro.data import pipeline

for name in D.SOURCES:
    for hosts, host in D.HOSTS:
        ds = D.make(vars(pipeline), name, hosts, host, {corpus!r})
        for step in D.STEPS:
            for k, v in ds.batch_at(step).items():
                res[f"{{name}}/{{hosts}}/{{host}}/{{step}}/{{k}}"] = v
""")


CLASSES = {"SyntheticCopyTask": SyntheticCopyTask,
           "SyntheticZipfLM": SyntheticZipfLM, "MemmapCorpus": MemmapCorpus}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_batches_equal_reference(reference, corpus, name):
    for hosts, host in HOSTS:
        ds = make(CLASSES, name, hosts, host, corpus)
        for step in STEPS:
            got = ds.batch_at(step)
            prefix = f"{name}/{hosts}/{host}/{step}/"
            want = {k[len(prefix):]: v for k, v in reference.items()
                    if k.startswith(prefix)}
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k].dtype == v.dtype, (prefix, k)
                np.testing.assert_array_equal(got[k], v, err_msg=prefix + k)
                assert got[k].shape[0] == SOURCES[name][1] // hosts


def test_data_determinism_and_host_sharding():
    """The reference's test: a batch is a function of (seed, step, host);
    the hosts' shards differ."""
    d1 = SyntheticCopyTask(100, batch=8, seq=16, seed=3)
    d2 = SyntheticCopyTask(100, batch=8, seq=16, seed=3)
    np.testing.assert_array_equal(d1.batch_at(7)["tokens"],
                                  d2.batch_at(7)["tokens"])
    h0 = SyntheticCopyTask(100, batch=8, seq=16, seed=3, num_hosts=2, host_id=0)
    h1 = SyntheticCopyTask(100, batch=8, seq=16, seed=3, num_hosts=2, host_id=1)
    assert h0.batch_at(0)["tokens"].shape[0] == 4
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])


def test_prefetcher_streams_batch_at():
    """From any start step, the prefetcher yields (step, batch_at(step)) in
    order."""
    ds = SyntheticZipfLM(1000, batch=4, seq=8, seed=2)
    pre = Prefetcher(ds, start_step=5)
    try:
        for step in range(5, 12):
            got_step, batch = pre.next()
            assert got_step == step
            for k, v in ds.batch_at(step).items():
                np.testing.assert_array_equal(batch[k], v)
    finally:
        pre.close()
