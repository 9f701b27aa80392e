"""Context parallelism at a sequence length the ``model`` axis does not
divide: reduced llama3.2-1b's ``seq_shard`` train step (the loss, every
gradient, the parameters, moments and metrics after one AdamW step) on
DTensors under gloo, against the same step in one process.

DTensor cuts T as ``torch.chunk`` does: ``ceil(T / n)`` rows a rank, the
last rank shorter.  At model 4, 18 rows are chunks of 5, 5, 5 and 3, so
the ranks' queries sit at positions 0, 5, 10 and 15; at model 2, 17 rows
are 9 and 8, at 0 and 9 (``tests/_sharding_workers.py`` ``UNEVEN_T``).
A rank's causal mask must be taken at those absolute positions
(``core/sharded.py`` ``attn_full``), not at ``r * (T // n)``.

Tolerance ``REL`` = 1e-5 of the largest one-process magnitude, as
``tests/test_torch_sharding_apply.py``: f32, only the order of the
all-reduce sums differs.
"""
import pytest

torch = pytest.importorskip("torch")

from _sharding_workers import UNEVEN_T, spawn_mesh  # noqa: E402

REL = 1e-5
MESHES = [(1, 4), (2, 2)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_seq_shard_train_step_at_uneven_T_matches_one_process(shape):
    T, n = UNEVEN_T[shape], shape[1]
    assert T % n, (shape, T)
    res = spawn_mesh(shape, kind="uneven")
    assert {"seq1/loss", "seq1/grads", "seq1/micro1/params",
            "seq1/micro1/moments", "seq1/micro1/metrics"} == set(res)
    for key, err in res.items():
        assert err <= REL, (shape, T, key, err)
