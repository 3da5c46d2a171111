"""The BENCH ``placement`` rows through the port, on the CPU: identity,
random and the reference's two annealed placements of each row (from the
random init and from the round-robin init, made by
``tests/fixtures/make_placement_golden.py`` on the non-partitionable
Threefry layout) simulate to the BENCH cycle counts through the port's
batched engine (``evaluate_placements``), and the port's cost model prices
them as the reference's search did. The full-budget anneals themselves are
held to these placements on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

from _torch_ref import ROOT

from repro_torch import place
from repro_torch.core import workloads as wl
from repro_torch.core.overlay import OverlayConfig
from repro_torch.place.spec import PlacementSpec

GOLDEN = ROOT / "tests" / "fixtures" / "placement_golden.npz"

#: row -> (arrow_lu_graph args, grid, BENCH cycles, BENCH anneal costs
#: (random init, annealed)), from BENCH_overlay.json.
ROWS = {
    "n3689": ((2, 8, 6), (8, 8),
              {"identity": 806, "random": 1021, "annealed": 684,
               "annealed_identity": 634}, (1_104_696, 1_045_048)),
    "n10308": ((4, 8, 8), (16, 16),
               {"identity": 1663, "random": 2139, "annealed": 1448,
                "annealed_identity": 1314}, (2_640_638, 2_302_114)),
}


@pytest.mark.parametrize("row", ROWS)
def test_bench_placement_row(row):
    args, (nx, ny), cycles, (init_cost, cost) = ROWS[row]
    z = np.load(GOLDEN)
    g = wl.arrow_lu_graph(*args, seed=3)
    res = place.evaluate_placements(g, nx, ny, {
        "identity": None,
        "random": PlacementSpec(strategy="random", seed=0),
        "annealed": z[f"{row}/annealed/node_pe"],
        "annealed_identity": z[f"{row}/annealed_identity/node_pe"],
    }, cfgs=OverlayConfig(scheduler="ooo", max_cycles=4_000_000),
        device="cpu")
    assert all(r.done for r in res.values())
    assert {k: r.cycles for k, r in res.items()} == cycles
    m = place.build_cost_model(g, nx, ny, device="cpu")
    assert int(m.cost(place.resolve(g, nx, ny, "random"))) == init_cost
    for tag in ("annealed", "annealed_identity"):
        pe = z[f"{row}/{tag}/node_pe"]
        assert int(m.cost(pe)) == int(z[f"{row}/{tag}/cost"])
        assert int(z[f"{row}/{tag}/replica_costs"].min()) == int(
            z[f"{row}/{tag}/cost"])
    assert int(z[f"{row}/annealed/init_cost"]) == init_cost
    assert int(z[f"{row}/annealed/cost"]) == cost
    if row == "n3689":
        # the reference's search on jax's default (partitionable) layout
        # lands elsewhere: the goldens need the non-partitionable stream
        assert int(z["n3689/partitionable/init_cost"]) == init_cost
        assert int(z["n3689/partitionable/cost"]) == 1_045_666 != cost
