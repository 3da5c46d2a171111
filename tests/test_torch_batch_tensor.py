"""Port vs reference: the batched sweep engine under ``engine="tensor"``
(the reference's ``"jnp"``) on the reference's own batch of
``tests/test_chunked.py`` (every policy, ``scan`` frozen at a budget of 100,
``ooo`` at select latency 4 finishing early) at check_every 1 and 32: each
element's cycles, counters and node values equal the reference's batch bit
for bit, and the port's solo run of its config.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference

ENGINE = "tensor"
RUNS = [("chunked", 1, ENGINE), ("chunked", 32, ENGINE)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_tensor", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)
