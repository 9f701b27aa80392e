"""The hybrid family's placed serving path: reduced zamba2-2.7b (f32),
stock and ``cut``, on DTensors under gloo at world sizes 2 and 4 on the
CPU (``tests/_ssm_workers.py``, ``kind="hybrid_serve"``).

* ``make_prefill_step`` and two ``make_serve_step`` calls, as the dry-run
  calls them, within ``REL`` of one process.
* The drip: four decode steps from an empty cache of the model compiled
  (quant attention projections, sparse MLP blocks) with the float and
  int4x2 caches, and of the raw model with the float cache: logits and
  every cache leaf (the Mamba2 states and conv windows, the shared
  attention's KV) within ``REL`` = 1e-5 of one process (relative to the
  largest magnitude); the placed cache keeps its tensors, updated through
  their local shards.  At a ``model`` axis of 4 the stock config's 2
  heads do not split: S stays replicated, each rank scans half a head
  and the ranks' rows of S are exchanged after each step.
* The raw drip's logits within ``REL`` of the reference's ``decode_step``
  on the same weights.
"""
import pytest

torch = pytest.importorskip("torch")

from _sharding_workers import spawn_mesh  # noqa: E402
from _ssm_reference import assert_matches_reference  # noqa: E402
from _ssm_workers import SIZES  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
DRIPS = ["compiled/float", "compiled/int4x2", "raw/float"]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="hybrid_serve")


@pytest.mark.parametrize("size", SIZES)
def test_hybrid_prefill_and_serve_steps_match_one_process(ranks, size):
    shape, res = ranks
    st = res[size]["steps"]
    assert st["prefill"] <= REL and st["serve"] <= REL, (shape, size, st)


@pytest.mark.parametrize("drip", DRIPS)
@pytest.mark.parametrize("size", SIZES)
def test_hybrid_drip_matches_one_process(ranks, size, drip):
    shape, res = ranks
    d = res[size][drip]
    assert d["logits"] <= REL and d["cache"] <= REL, (shape, size, drip, d)
    assert d["same_tensors"] and d["placed"], (shape, size, drip)


def test_hybrid_placed_drip_matches_reference(ranks):
    _, res = ranks
    assert_matches_reference(res["stock"]["raw/float"]["got"], "zamba2-2.7b",
                             REL)
