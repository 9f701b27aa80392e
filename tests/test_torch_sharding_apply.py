"""The sharding rules applied: reduced llama3.2-1b's train step and compiled
decode step on DTensors, under gloo at world sizes 2 and 4 on the CPU,
against the same computation in one process.

Meshes ``(data, model)``: (1, 2), (2, 1), (2, 2) and (1, 4).  Each mesh
spawns its ranks once (``tests/_sharding_workers.py``, which says what each
case runs) and the tests read rank 0's numbers.

Tolerances, relative to the largest one-process magnitude: ``REL`` = 1e-5
for the loss, the gradients, the parameters and moments after one AdamW
step and the decode logits and cache (f32: only the order of the
all-reduce sums differs; the int4x2 cache's codes must not move, and do
not).
"""
import pytest

torch = pytest.importorskip("torch")

from _sharding_workers import KV, spawn_mesh  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param)


def test_train_step_matches_one_process(ranks):
    shape, res = ranks
    tr = res["train"]
    for key, err in tr.items():
        assert err <= REL, (shape, key, err)
    assert {"seq0/micro1/params", "seq0/micro2/params",
            "seq1/micro1/params", "seq1/grads"} <= set(tr)


def test_decode_step_matches_one_process(ranks):
    shape, res = ranks
    dec = res["decode"]
    # at (1, 4) the 2 kv heads do not split over 4 model ranks: the cache is
    # sequence-sharded, each rank's range read and the parts combined
    for kv in KV:
        assert dec[f"{kv}/logits"] <= REL, (shape, kv, dec)
        assert dec[f"{kv}/cache"] <= REL, (shape, kv, dec)
    # the crafted stripes partition: wg, wu and wd run local schedules
    want = 3 if shape[1] > 1 else 0
    assert dec["pattern_sharded"] == want, dec
    assert dec["local_patterns"] == (2 if shape[1] > 1 else 0), dec


def test_kernel_wrapper_refuses_a_dtensor(ranks):
    _, res = ranks
    assert res["refuse"] and "DTensor" in res["refuse"]


def test_multi_host_checkpoint_restores_to_placements(ranks):
    """Each rank a host (two or four): every host writes its share, and the
    restore places the whole arrays by the mesh's placements again."""
    shape, res = ranks
    world = shape[0] * shape[1]
    ck = res["ckpt"]
    assert ck["equal"] and ck["placements"], ck
    assert ck["n_hosts"] == world
    assert ck["files"] == [f"host_{h}.npz" for h in range(world)]
    assert ck["note"] == "n hosts"
