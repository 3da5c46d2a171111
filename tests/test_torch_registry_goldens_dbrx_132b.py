"""dbrx-132b's f32 golden and its bf16 twin against the recipe that made
them, in one walk (``test_torch_registry_goldens.check_twins``): a file of
its own, as the walk is the longest of the fixture checks."""
from test_torch_registry_goldens import check_twins


def test_golden_and_bf16_twin_match_recipe():
    check_twins("dbrx-132b")
