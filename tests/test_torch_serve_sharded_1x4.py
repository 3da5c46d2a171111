"""The port's sharded serve steps on a 1x4 mesh of 4 gloo ranks (one data
rank: every rank holds every row; the parameters and the cache's heads
split over ``"model"``): the dense, MoE with MLA, hybrid and whisper cases
of ``tests/_torch_serve.py``, each rank's logits, tokens and cache block
equal to the one-device steps' bit for bit (gather-then-compute runs the
one-device arithmetic on the gathered tensors)."""
import pytest

from _torch_ref import run_ranks
import _torch_serve as S


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, "serve_1x4", 4,
                     "MESH = (1, 4)\n" + S.RANK_BODY)


@pytest.mark.parametrize("case", sorted(S.CASES))
def test_1x4_is_one_device(ranks, case):
    want = S.run_one_device(case)
    for r, res in enumerate(ranks):
        got = S.case_of(res, case)
        assert int(got["rows"][1]) == S.B
        S.assert_rank_matches(got, want, exact=True, label=f"{case} rank {r}")
