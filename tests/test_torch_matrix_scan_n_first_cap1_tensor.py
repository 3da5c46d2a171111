"""Port vs reference on the small matrix graph, ``scan`` policy, eject
configuration ``n_first_cap1``, engine ``tensor``, at check_every 1 and 8: cycle
counts, stat counters and node values equal bit for bit. ``scan`` runs
~8,650 cycles a cell, so its cells are split over six files, each short
enough on the CPU.
"""
import pytest

from _torch_ref import (GOLDENS, assert_matches, matrix_reference,
                        port_matrix_run)

POLICY = "scan"
ENGINES = ('tensor',)
CELLS = [(k, 'n_first_cap1') for k in (1, 8)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return matrix_reference(tmp_path_factory, POLICY, CELLS)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("check_every,eject", CELLS)
def test_matches_reference(reference, check_every, eject, engine):
    r = port_matrix_run(POLICY, check_every, eject, engine)
    assert_matches(r, reference, f"{check_every}/{eject}")


@pytest.mark.parametrize("engine", ENGINES)
def test_golden_counts(engine):
    r = port_matrix_run(POLICY, 1, "n_first_cap1", engine)
    assert r.done
    assert (r.cycles, r.deflections) == GOLDENS[POLICY]
    assert (r.busy_cycles, r.delivered) == (1777, 3554)
