"""The SSM family's placed serving path: reduced xlstm-1.3b (f32), stock
and ``cut``, on DTensors under gloo at world sizes 2 and 4 on the CPU
(``tests/_ssm_workers.py``, ``kind="xlstm_serve"``).

* ``make_prefill_step`` and two ``make_serve_step`` calls, as the dry-run
  calls them, within ``REL`` of one process.
* The drip: four decode steps from an empty cache with dense and with
  int8 mLSTM leaves (the quant family's codes and per-column scales,
  column- and row-parallel): logits and every cache leaf (the mLSTM's S
  and n on each rank's key rows, the sLSTM's h, c, n) within ``REL`` =
  1e-5 of one process (relative to the largest magnitude); the placed
  cache keeps its tensors, updated through their local shards.
* The dense drip at ``d_inner`` 120 (heads of 30 key features, which a
  ``model`` axis of 4 does not divide: the mLSTM state replicated, each
  rank updating its rows) within ``REL`` of one process.
* The dense drip's logits within ``REL`` of the reference's
  ``decode_step`` on the same weights.
"""
import pytest

torch = pytest.importorskip("torch")

from _sharding_workers import spawn_mesh  # noqa: E402
from _ssm_reference import assert_matches_reference  # noqa: E402
from _ssm_workers import SIZES  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
DRIPS = ["dense/float", "int8/float"]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="xlstm_serve")


@pytest.mark.parametrize("size", SIZES)
def test_xlstm_prefill_and_serve_steps_match_one_process(ranks, size):
    shape, res = ranks
    st = res[size]["steps"]
    assert st["prefill"] <= REL and st["serve"] <= REL, (shape, size, st)


@pytest.mark.parametrize("drip", DRIPS)
@pytest.mark.parametrize("size", SIZES)
def test_xlstm_drip_matches_one_process(ranks, size, drip):
    shape, res = ranks
    d = res[size][drip]
    assert d["logits"] <= REL and d["cache"] <= REL, (shape, size, drip, d)
    assert d["same_tensors"] and d["placed"], (shape, size, drip)


def test_xlstm_drip_with_uneven_key_rows_matches_one_process(ranks):
    shape, res = ranks
    d = res["odd"]["dense/float"]
    assert d["logits"] <= REL and d["cache"] <= REL, (shape, d)
    assert d["same_tensors"] and d["placed"], shape


def test_xlstm_placed_drip_matches_reference(ranks):
    _, res = ranks
    assert_matches_reference(res["stock"]["dense/float"]["got"], "xlstm-1.3b",
                             REL)
