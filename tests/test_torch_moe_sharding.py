"""The MoE family's placed train step: reduced olmoe-1b-7b and
qwen2-moe-a2.7b (f32; 8 experts, top-4, ``Fe`` 32; qwen2-moe-a2.7b with one
shared expert) on DTensors under gloo at world sizes 2 and 4 on the CPU,
against the same step in one process.

Meshes ``(data, model)``: (1, 2), (2, 1), (2, 2) and (1, 4), each spawned
once for both configs (``tests/_moe_workers.py``, ``kind="moe_train"``,
which says what each case runs).  The MoE layer's leg
(``repro_torch.core.sharded.moe``) gathers the tokens, routes all of them
on every rank with the global capacity, and computes each rank's
capacity rows on its ``Fe`` columns.

Tolerances, relative to the largest one-process magnitude: ``REL`` = 1e-5
for the loss, every gradient and every parameter and moment after one
AdamW step (``n_micro`` 1 and 2, ``seq_shard`` off and on), with the norm
gains in f32; with the gains in bf16, as the model makes them, every f32
gradient to ``REL`` and each gain's gradient within one bf16 step an
element (its f32 sum is rounded once, and the placed sum's order moves
the last f32 bits).  A step with frozen expert masks: parameters to
``REL``, pruned weights exactly zero.
"""
import pytest

torch = pytest.importorskip("torch")

from _moe_workers import ARCHS  # noqa: E402
from _sharding_workers import spawn_mesh  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="moe_train")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_matches_one_process(ranks, arch):
    shape, res = ranks
    tr = res[arch]["f32"]
    for key, err in tr.items():
        assert err <= REL, (shape, arch, key, err)
    assert {"seq0/grads", "seq0/micro1/params", "seq0/micro1/moments",
            "seq0/micro2/params", "seq0/micro2/moments",
            "seq1/micro1/params", "seq1/grads"} <= set(tr)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_gains_within_one_rounding(ranks, arch):
    shape, res = ranks
    g = res[arch]["bf16_gains"]
    assert g["loss"] <= REL and g["grads"] <= REL, (shape, arch, g)
    assert g["n_bf16"] == 3, g     # ln1 and ln2 (stacked), final_norm
    assert g["steps"] <= 1.0, (shape, arch, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_masked_train_step(ranks, arch):
    """Frozen expert masks placed like their weights: the step's
    parameters match one process's and pruned weights stay zero."""
    shape, res = ranks
    m = res[arch]["masked"]
    assert m["params"] <= REL, (shape, arch, m)
    assert m["pruned_zero"], (shape, arch)
