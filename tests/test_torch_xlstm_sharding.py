"""The SSM family's placed train step: reduced xlstm-1.3b (f32), stock and
``cut`` (``n_heads`` 2, ``d_inner`` 256, ``slstm_every`` 2: ``wq`` cut at
half a head and the mLSTM state at 32 of 128 key rows at ``model`` 4), on
DTensors under gloo at world sizes 2 and 4 on the CPU, against the same
step in one process.

Meshes ``(data, model)``: (1, 2), (2, 1), (2, 2) and (1, 4), each spawned
once for both sizes (``tests/_ssm_workers.py``, ``kind="xlstm_train"``,
which says what each case runs).  The mLSTM leg
(``repro_torch.core.sharded.mlstm``) runs each rank's key features of
every head, its partial scores and inter-chunk terms reduced in f32; the
sLSTM leg (``sharded.slstm``) runs the whole step loop on every rank.

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
    return request.param, spawn_mesh(request.param, kind="xlstm_train")


@pytest.mark.parametrize("size", SIZES)
def test_xlstm_train_step_matches_one_process(ranks, size):
    shape, res = ranks
    tr = res[size]["f32"]
    for key, err in tr.items():
        assert err <= REL, (shape, size, key, err)
    assert {"seq0/grads", "seq0/micro1/params", "seq0/micro1/moments",
            "seq0/micro2/params", "seq0/micro2/moments",
            "seq1/micro1/params", "seq1/grads"} <= set(tr)


@pytest.mark.parametrize("size", SIZES)
def test_xlstm_bf16_gains_within_one_rounding(ranks, size):
    shape, res = ranks
    g = res[size]["bf16_gains"]
    assert g["loss"] <= REL and g["grads"] <= REL, (shape, size, g)
    assert g["n_bf16"] == 3, g     # s_ln, m_ln (stacked), final_norm
    assert g["steps"] <= 1.0, (shape, size, g)


# (H, P, n): xlstm-1.3b at model 16, the cut config at 4, the stock reduced
# config's odd key width (uneven key slices) at 4
@pytest.mark.parametrize("H,P,n", [(4, 1024, 16), (2, 128, 4), (4, 30, 4)])
def test_mlstm_layout_built_once_and_delivered_by_its_all_to_all(H, P, n):
    """Each rank's layout (``ssm.mlstm_layout``) is made once a device; the
    all-to-all its plan describes hands every rank exactly its key
    features ``[p0, p1)`` of every head, and the key slices and output
    columns tile the whole."""
    from repro_torch.models import ssm

    cpu = torch.device("cpu")
    lays = [ssm.mlstm_layout(H, P, n, r, cpu) for r in range(n)]
    assert all(lay is ssm.mlstm_layout(H, P, n, r, cpu)
               for r, lay in enumerate(lays))
    plans = [lay["take"] for lay in lays]
    if H * P % n == 0:
        for r, got in enumerate(delivered(plans, H * P)):
            assert np.array_equal(got, plans[r].cols.numpy()), r
    assert [(lay["p0"], lay["p1"]) for lay in lays] == [
        (r * P // n, (r + 1) * P // n) for r in range(n)]
    for lay in lays:
        want = (np.arange(H)[:, None] * P
                + np.arange(lay["p0"], lay["p1"])[None]).reshape(-1)
        assert np.array_equal(lay["take"].cols.numpy(), want)
        assert lay["h0"] == lay["c0"] // P
    if lays[0]["cols_cut"]:
        assert [lay["c0"] for lay in lays[1:]] == [
            lay["c1"] for lay in lays[:-1]] and lays[-1]["c1"] == H * P
