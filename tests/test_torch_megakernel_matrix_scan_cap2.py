"""Port vs reference on the small matrix graph, ``scan`` policy, eject
configuration ``cap2``, both under ``engine="megakernel"`` at
check_every 32: cycle counts, stat counters and node values equal bit for
bit. On the CPU the port runs the kernel's plain version; the reference
runs its Pallas megakernel in interpret mode. ``scan`` runs ~8,650 cycles
a cell, so its eject configurations are split over three files.
"""
import pytest

from _torch_ref import assert_matches, matrix_reference, port_matrix_run

POLICY = "scan"
CELLS = [(32, 'cap2')]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return matrix_reference(tmp_path_factory, POLICY, CELLS,
                            engine="megakernel")


@pytest.mark.parametrize("check_every,eject", CELLS)
def test_matches_reference_megakernel(reference, check_every, eject):
    r = port_matrix_run(POLICY, check_every, eject, "megakernel")
    assert_matches(r, reference, f"{check_every}/{eject}")

