"""Port vs reference: the batched sweep engine under
``engine="megakernel"`` on the reference's batch of
``tests/test_megakernel.py:62-75`` (``layered_dag(4, 6, seed=3)`` on 2x2,
every policy, ``scan`` frozen at a budget of 20) at check_every 1, 8 and
32, and the launch counter: bit for bit against the reference's batched
Pallas megakernel (interpret mode) and the port's solo runs.
"""
import pytest

from _torch_ref import assert_batch_matches, batch_reference, port_batch_run
from repro_torch.kernels import megakernel

ENGINE = "megakernel"
RUNS = [("layered", K, ENGINE) for K in (1, 8, 32)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return batch_reference(tmp_path_factory, "batch_megakernel_layered", RUNS)


@pytest.mark.parametrize("case,check_every,engine", RUNS)
def test_batch_matches_reference(reference, case, check_every, engine):
    assert_batch_matches(reference, case, check_every, engine)


def test_no_kernel_launch_on_cpu():
    port_batch_run.cache_clear()
    megakernel.reset_launches()
    results = port_batch_run("layered", 8, ENGINE)
    assert [r.cycles for r in results] == [26, 28, 24, 28, 20]
    assert megakernel.launches == {"mega_chunk": 0, "mega_chunk_batched": 0,
                                   "mega_chunk_shared": 0,
                                   "mega_chunk_global": 0,
                                   "mega_chunk_traced": 0}
