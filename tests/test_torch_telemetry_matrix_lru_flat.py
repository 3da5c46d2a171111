"""Port vs reference traces on the small matrix graph (2x2), ``lru_flat``
policy, every eject configuration (n_first and priority at capacity 1,
capacity 2), with ``TelemetrySpec(buckets=16, bucket_cycles=8)``: every
trace leaf, counter and node value of the port's ``tensor``, ``select`` and
``megakernel`` engines (on the CPU) at check_every 1, 7 and auto equals the
reference's ``jnp`` engine bit for bit.
"""
import pytest

from _torch_ref import (EJECTS, assert_telemetry_matches, port_telemetry_run,
                        telemetry_cell, telemetry_reference)

POLICY = "lru_flat"
ENGINES = ('tensor', 'select', 'megakernel')
CELLS = [telemetry_cell(POLICY, eject) for eject in EJECTS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return telemetry_reference(tmp_path_factory, "telemetry_lru_flat", CELLS)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("check_every", [1, 7, None], ids=["1", "7", "auto"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[2])
def test_traces_match_reference(reference, cell, check_every, engine):
    r = port_telemetry_run(cell, check_every, engine)
    assert_telemetry_matches(r, reference, cell[0])
