"""The port's dry-run (``repro_torch.launch.dryrun.run_cell``, ``--device
cpu``) at the reference's compiled smoke cells of minicpm-2b, gemma-2b,
qwen2-0.5b, starcoder2-7b: every shape the fixture compiled, on the 256- and
the 512-rank mesh, checked by ``tests/_torch_dryrun.py``'s ``check_cell``."""
import pytest

from _torch_dryrun import cells, check_cell

ARCHS = ('minicpm-2b', 'gemma-2b', 'qwen2-0.5b', 'starcoder2-7b')


@pytest.mark.parametrize("key", cells(ARCHS))
def test_smoke_cell_matches_reference(key):
    check_cell(key)
