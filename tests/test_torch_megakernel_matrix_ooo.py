"""Port vs reference on the small matrix graph, ``ooo`` policy, both under
``engine="megakernel"`` at check_every 32, for each eject configuration
(n_first and priority at capacity 1, capacity 2): cycle counts, stat
counters and node values equal bit for bit. On the CPU the port runs the
kernel's plain version; the reference runs its Pallas megakernel in
interpret mode.
"""
import pytest

from _torch_ref import (EJECTS, GOLDENS, assert_matches, matrix_reference,
                        port_matrix_run)

POLICY = "ooo"
CELLS = [(32, eject) for eject in EJECTS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return matrix_reference(tmp_path_factory, POLICY, CELLS,
                            engine="megakernel")


@pytest.mark.parametrize("check_every,eject", CELLS)
def test_matches_reference_megakernel(reference, check_every, eject):
    r = port_matrix_run(POLICY, check_every, eject, "megakernel")
    assert_matches(r, reference, f"{check_every}/{eject}")


@pytest.mark.parametrize("eject,golden", [("n_first_cap1", GOLDENS[POLICY]),
                                          ("cap2", (1055, 514))])
def test_golden_counts(eject, golden):
    r = port_matrix_run(POLICY, 32, eject, "megakernel")
    assert r.done
    assert (r.cycles, r.deflections) == golden
    assert (r.busy_cycles, r.delivered) == (1777, 3554)
