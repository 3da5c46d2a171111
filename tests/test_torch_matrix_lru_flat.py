"""Port vs reference on the small matrix graph, ``lru_flat`` policy: every
check_every (1, 8) x eject configuration (n_first and priority at capacity
1, capacity 2) x engine (``tensor``, ``select``) cell. Cycle counts, stat
counters and node values must be equal bit for bit.
"""
import pytest

from _torch_ref import (EJECTS, GOLDENS, assert_matches, matrix_reference,
                        port_matrix_run)

POLICY = "lru_flat"
ENGINES = ('tensor', 'select')
CELLS = [(k, eject) for k in (1, 8) for eject in EJECTS]


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
