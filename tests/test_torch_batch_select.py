"""Port vs reference: the batched sweep engine under ``engine="select"`` on
the ``tests/test_chunked.py`` batch at check_every 7 (the reference runs
its Pallas leading-one kernels in interpret mode; on the CPU the port runs
their plain versions, element by element): bit for bit against the
reference's batch and the port's solo runs.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference

ENGINE = "select"
RUNS = [("chunked", 7, ENGINE)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_select", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)
