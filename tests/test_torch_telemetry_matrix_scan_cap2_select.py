"""Port vs reference traces on the small matrix graph (2x2), ``scan`` policy,
eject configuration ``cap2``, with ``TelemetrySpec(buckets=16,
bucket_cycles=8)``: every trace leaf, counter and node value of the port's
``select`` engine (on the CPU) at check_every 1, 7 and auto equals the
reference's ``jnp`` engine bit for bit. ``scan`` runs ~8,650 cycles a cell,
so its cells are split over nine files, each short enough on the CPU.
"""
import pytest

from _torch_ref import (assert_telemetry_matches, port_telemetry_run,
                        telemetry_cell, telemetry_reference)

POLICY = "scan"
ENGINES = ('select',)
CELLS = [telemetry_cell(POLICY, eject) for eject in ['cap2']]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return telemetry_reference(tmp_path_factory,
                               "telemetry_scan_cap2_select", CELLS)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("check_every", [1, 7, None], ids=["1", "7", "auto"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[2])
def test_traces_match_reference(reference, cell, check_every, engine):
    r = port_telemetry_run(cell, check_every, engine)
    assert_telemetry_matches(r, reference, cell[0])
