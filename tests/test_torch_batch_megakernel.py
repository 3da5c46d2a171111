"""Port vs reference: the batched sweep engine under
``engine="megakernel"`` on the reference's own batch of
``tests/test_chunked.py`` at check_every 1 and 32. On the CPU the port runs
the batched kernel's plain version (``mega_batch_chunk_plain``); the
reference runs its Pallas megakernel (``batched=True``) in interpret mode.
Each element equals the reference's batch bit for bit, and the port's solo
run of its config.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference

ENGINE = "megakernel"
RUNS = [("chunked", 1, ENGINE), ("chunked", 32, ENGINE)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_megakernel", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)
