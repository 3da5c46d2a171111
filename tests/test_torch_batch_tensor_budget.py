"""Port vs reference: the batched sweep engine under ``engine="tensor"``
(the reference's ``"jnp"``) on the ``tests/test_chunked.py`` batch at
check_every 7, on the budget that ends exactly on a chunk boundary (98 at
K = 7, ``tests/test_chunked.py:91-105``) and on the
``tests/test_megakernel.py`` batch (``layered_dag``, ``scan`` at a budget
of 20) at check_every 1, 8 and 32: bit for bit against the reference's
batch and the port's solo runs.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference

ENGINE = "tensor"
RUNS = [("chunked", 7, ENGINE), ("budget", 7, ENGINE),
        *(("layered", K, ENGINE) for K in (1, 8, 32))]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_tensor_budget", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)
