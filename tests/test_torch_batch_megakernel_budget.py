"""Port vs reference: the batched sweep engine under
``engine="megakernel"`` on the ``tests/test_chunked.py`` batch at
check_every 7 and on its budget that ends exactly on a chunk boundary (98
at K = 7): bit for bit against the reference's batched Pallas megakernel
(interpret mode) and the port's solo runs.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference

ENGINE = "megakernel"
RUNS = [("chunked", 7, ENGINE), ("budget", 7, ENGINE)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_megakernel_budget", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)
