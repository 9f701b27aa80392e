"""The hybrid family's placed train step: reduced zamba2-2.7b (f32), stock
and ``cut`` (``d_inner`` 256: one of 4 Mamba2 heads a rank at ``model``
4), on DTensors under gloo at world sizes 2 and 4 on the CPU, against the
same step in one process.

Meshes ``(data, model)``: (1, 2), (2, 1), (2, 2) and (1, 4), each spawned
once for both sizes (``tests/_ssm_workers.py``, ``kind="hybrid_train"``,
which says what each case runs).  The Mamba2 leg
(``repro_torch.core.sharded.mamba2``) scans each rank's ``di`` channels
from ``win``'s columns moved by one all-to-all; the shared attention and
MLP take the dense legs.

Tolerances, relative to the largest one-process magnitude: ``REL`` = 1e-5
for the loss, every gradient and every parameter and moment after one
AdamW step (``n_micro`` 1 and 2, ``seq_shard`` off and on), with the norm
gains in f32; with the gains in bf16, every f32 gradient to ``REL`` and
each gain's gradient within one bf16 step an element.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _sharding_workers import spawn_mesh  # noqa: E402
from _ssm_workers import SIZES, delivered  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="hybrid_train")


@pytest.mark.parametrize("size", SIZES)
def test_hybrid_train_step_matches_one_process(ranks, size):
    shape, res = ranks
    tr = res[size]["f32"]
    for key, err in tr.items():
        assert err <= REL, (shape, size, key, err)
    assert {"seq0/grads", "seq0/micro1/params", "seq0/micro1/moments",
            "seq0/micro2/params", "seq0/micro2/moments",
            "seq1/micro1/params", "seq1/grads"} <= set(tr)


@pytest.mark.parametrize("size", SIZES)
def test_hybrid_bf16_gains_within_one_rounding(ranks, size):
    shape, res = ranks
    g = res[size]["bf16_gains"]
    assert g["loss"] <= REL and g["grads"] <= REL, (shape, size, g)
    # m_ln (stacked), the shared block's ln and ln2, final_norm
    assert g["n_bf16"] == 4, g
    assert g["steps"] <= 1.0, (shape, size, g)


# (H, P, N, n): zamba2-2.7b at model 16, the cut config at 4, the stock
# reduced config (2 heads) at 4, where a rank's channels are half a head
@pytest.mark.parametrize("decode", [False, True], ids=["seq", "decode"])
@pytest.mark.parametrize("H,P,N,n", [(80, 64, 64, 16), (4, 64, 16, 4),
                                     (2, 64, 16, 4)])
def test_mamba_layout_built_once_and_delivered_by_its_all_to_all(
        H, P, N, n, decode):
    """Each rank's layout (``ssm.mamba_layout``) is made once a device, and
    the all-to-all its plan describes, where the rules cut the width,
    hands every rank exactly the ``win`` columns (and, decoding, the
    conv-state channels) it takes."""
    from repro_torch.models import ssm

    cpu = torch.device("cpu")
    lays = [ssm.mamba_layout(H, P, N, n, r, True, decode, cpu)
            for r in range(n)]
    assert all(lay is ssm.mamba_layout(H, P, N, n, r, True, decode, cpu)
               for r, lay in enumerate(lays))
    di = H * P
    takes = [("take", 2 * di + 2 * N + H)] + (
        [("conv_take", di + 2 * N)] if decode else [])
    for key, width in takes:
        if width % n:       # the rules keep it whole: each rank's own cols
            continue
        plans = [lay[key] for lay in lays]
        for r, got in enumerate(delivered(plans, width)):
            assert np.array_equal(got, plans[r].cols.numpy()), (key, r)
    for lay in lays:
        mine = lay["take"].cols[lay["at_mine"]]
        dl = lay["Hl"] * lay["Pl"]
        assert len(mine) == 2 * dl + 2 * N + lay["Hl"]
        assert int(mine[0]) == lay["c0"] and int(mine[dl]) == di + lay["c0"]
