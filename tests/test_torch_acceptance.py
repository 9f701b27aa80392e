"""The port's model-zoo acceptance matrix vs the committed
``BENCH_zoo_matrix.json`` and the reference's ``repro.core.acceptance``.

The environments get the reference's weights, carried across as numpy:
container bytes depend on the weights (``compile_model`` unions
same-shape bitmaps), so only identical weights can give the committed
bytes.  The committed file was written under JAX's legacy threefry
(``jax_threefry_partitionable=False``, the default before JAX 0.5): under
today's default ``jax.random.PRNGKey(0)`` draws other weights, and the
reference's own ``check_matrix`` then misses 11 cells' bytes and 3 cells'
top-1.  So the reference's weights are drawn under the legacy threefry.

Every cell that runs must pass the reference's ``check_matrix`` rules
against the committed row: container bytes exactly, stored-bits ratio
within 1e-6 of it, dense top-1 within ``TOP1_REGRESSION_TOL``, every
floor, the ``expected_fail`` cells failing their dense floor.  The
``autotune@8`` cells run too (``tuned_policy``'s picks) and are held to
the committed bytes, where the reference exempts them.
"""
import json
import pathlib

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import acceptance as jacc  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import acceptance as acc  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = json.loads((ROOT / "BENCH_zoo_matrix.json").read_text())
RUN = [acc.cell_key(*s) for s in acc.cell_specs()
       if (s[1], s[2]) not in acc.NOT_RUN]
AUTOTUNE = [acc.cell_key(c, "autotune", 8) for c in acc.ZOO_CONFIGS]
CONSTANTS = ["ZOO_TRANSFORMERS", "ZOO_CONFIGS", "POLICY_GRID",
             "WEIGHT_PRESERVING", "EXPECTED_FAIL", "ORACLE_TOP1_FLOOR",
             "ORACLE_MSE_CEIL", "ACTSPARSE_ORACLE_TOP1_FLOOR",
             "ACTSPARSE_ORACLE_MSE_CEIL", "DENSE_TOP1_FLOOR",
             "TOP1_REGRESSION_TOL", "ACT_THRESHOLD", "BATCH", "SEQ",
             "LENET_BATCH", "STEADY_ITERS", "STEADY_WARMUP", "LENET_BLOCKS"]


def _reference_weights():
    with jax.threefry_partitionable(False):
        trees = {c: jm.init_params(jax.random.PRNGKey(0), j_reduced(c))
                 for c in acc.ZOO_TRANSFORMERS}
        trees["lenet"] = jlenet.init_lenet(jax.random.PRNGKey(0))
    return {c: interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t), "cpu")
        for c, t in trees.items()}


@pytest.fixture(scope="module")
def weights():
    return _reference_weights()


@pytest.fixture(scope="module")
def checked(weights):
    lines = []
    return acc.check_matrix(COMMITTED, log=lines.append, device="cpu",
                            params=weights), lines


@pytest.fixture(scope="module")
def built(weights):
    return acc.build_matrix(time_cells=False, log=lambda s: None,
                            device="cpu", params=weights)


@pytest.mark.parametrize("name", CONSTANTS)
def test_grid_and_floors_are_the_references(name):
    assert getattr(acc, name) == getattr(jacc, name)


def test_grid_extents_and_key_format_pinned():
    """4 configs x 8 policies x 4 bit-widths: 64 cells, as committed."""
    specs = acc.cell_specs()
    assert specs == jacc.cell_specs()
    assert len(specs) == len(set(specs)) == 64
    assert len(acc.ZOO_CONFIGS) >= 4
    assert len({p for _, p, _ in specs}) >= 5
    assert len({b for _, _, b in specs}) >= 3
    assert acc.cell_key("lenet", "quant", 4) == "lenet/quant@4"
    assert {acc.cell_key(*s) for s in specs} == set(COMMITTED["cells"])
    assert len(RUN) == 64 and len(AUTOTUNE) == 4


@pytest.mark.parametrize("key", RUN)
def test_cell_passes_against_committed_row(checked, key):
    chk, _ = checked
    assert key in chk.results
    assert [f for f in chk.fails if f.startswith(key + ":")] == []


def test_check_has_no_structural_failure(checked):
    chk, lines = checked
    assert chk.fails == []
    assert sum("not run" in ln for ln in lines) == 0


@pytest.mark.parametrize("config", acc.ZOO_CONFIGS)
def test_expected_fail_cells_fail_and_bfp8_at_2_passes(checked, config):
    chk, _ = checked
    floor = acc.DENSE_TOP1_FLOOR[2]
    for policy in ("quant", "perchannel"):
        r = chk.results[acc.cell_key(config, policy, 2)]
        assert r.expected_fail and r.reason
        assert r.dense_top1 < floor
    b2 = chk.results[acc.cell_key(config, "bfp8", 2)]
    assert not b2.expected_fail and b2.dense_top1 >= floor


def test_every_cell_runs(checked, built):
    """All 64 cells run, the 4 autotune cells among them, with the
    reference's ``tuned_policy`` picks (``sparse`` everywhere)."""
    chk, _ = checked
    assert acc.NOT_RUN == {} and chk.not_run == {} and built["not_run"] == {}
    assert sorted(chk.results) == sorted(built["cells"]) == sorted(RUN)
    for key in AUTOTUNE:
        assert built["cells"][key]["policies_used"] == ["sparse"]


@pytest.mark.parametrize("key", RUN)
def test_built_row_equals_committed_row(built, key):
    """build_matrix's rows carry the committed row's fields: bytes and
    policies exactly, the ratio within 1e-6, top-1 within one of the 64
    argmax positions and the MSEs within f32 rtol 1e-5 (the two packages
    sum in different orders)."""
    row, want = built["cells"][key], COMMITTED["cells"][key]
    assert set(row) == set(want) - {"decode_us"}
    for k in ("config", "policy", "bits", "container_bytes",
              "policies_used", "expected_fail"):
        assert row[k] == want[k], k
    assert row.get("reason") == want.get("reason")
    assert abs(row["stored_bits_ratio"] - want["stored_bits_ratio"]) <= \
        1e-6 * max(1.0, want["stored_bits_ratio"])
    for k in ("oracle_top1", "dense_top1"):
        assert abs(row[k] - want[k]) <= 1 / 64 + 1e-9, k
    np.testing.assert_allclose(row["dense_mse"], want["dense_mse"],
                               rtol=1e-5, atol=1e-6)
    assert row["oracle_mse"] <= (acc.ACTSPARSE_ORACLE_MSE_CEIL
                                 if row["policy"] == "actsparse"
                                 else acc.ORACLE_MSE_CEIL)


def test_built_payload_schema_grid_and_floors(built):
    for k in ("schema", "grid", "floors"):
        assert built[k] == COMMITTED[k], k


@pytest.mark.parametrize("config", ["lenet", "starcoder2-7b"])
def test_steady_timing_runs_on_the_cpu(weights, config):
    """``decode_us`` comes from the same cell run; on the CPU it is a host
    time of the plain versions, never a device number."""
    env = acc.make_env(config, "cpu", weights[config])
    r = env.evaluate("quant", 4, time_decode=True)
    assert r.decode_us is not None and r.decode_us > 0
    assert "decode_us" in r.to_row()


def test_fused_fc_stack_keeps_the_actsparse_threshold(weights):
    """The fused FC stack runs each payload's own epilogue: with actsparse
    payloads the fc1 / fc2 ReLUs are threshold-ReLUs, as the reference's
    per-leaf chain applies them (the lenet/actsparse@16 cell)."""
    import torch

    from repro.core import compile_sparse as jc
    from repro_torch.core import compile_sparse as tc
    from repro_torch.models import lenet as tlenet

    with jax.threefry_partitionable(False):
        jenv = jacc._make_env("lenet")
    tenv = acc.make_env("lenet", "cpu", weights["lenet"])
    jcm = jc.compile_lenet(jenv.params, jenv.masks, blocks=acc.LENET_BLOCKS,
                           rules=jacc._rules_for("actsparse", 16, jenv.names))
    tcm = tc.compile_lenet(tenv.params, tenv.masks, blocks=acc.LENET_BLOCKS,
                           rules=acc._rules_for("actsparse", 16, tenv.names),
                           device="cpu")
    assert tcm.fusion["fc_stack"] == ("fc1", "fc2", "fc3")
    want = np.asarray(jlenet.lenet_forward(jenv.params, jenv.x,
                                           compressed=jcm.layers,
                                           fusion=jcm.fusion))
    with torch.no_grad():
        got = tlenet.lenet_forward(tenv.params, tenv.x, compressed=tcm.layers,
                                   fusion=tcm.fusion).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_floor_fails_holds_the_reference_weights_build(built):
    assert acc.floor_fails(built) == []


def test_floor_fails_names_each_broken_condition(built):
    import copy

    cases = {
        "llama3.2-1b/quant@8": ("oracle_top1", 0.5, "oracle top-1"),
        "qwen1.5-4b/quant@2": ("dense_top1", 0.9, "expected_fail"),
        "lenet/bfp8@2": ("dense_top1", 0.1, "lenet/bfp8@2"),
    }
    for key, (field, value, said) in cases.items():
        bad = copy.deepcopy(built)
        bad["cells"][key][field] = value
        fails = acc.floor_fails(bad)
        assert len(fails) == 1 and said in fails[0], (key, fails)
    bad = copy.deepcopy(built)
    bad["not_run"][AUTOTUNE[0]] = "dropped"
    assert acc.floor_fails(bad) and "not run" in acc.floor_fails(bad)[0]


def test_own_weights_are_drawn_on_the_host_and_pass_the_floors():
    """Without weights the environments draw the port's seed-0 weights on
    the host (a torch.Generator's numbers depend on its device), so the
    card's cells are the CPU's; on them every check that needs no
    committed file holds."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.models.lenet import init_lenet
    from repro_torch.models.model import init_params

    env = acc.make_env("starcoder2-7b", "cpu")
    want = init_params(reduced_config("starcoder2-7b"), seed=0, device="cpu")
    for (path, a), (_, b) in zip(_items(env.params), _items(want)):
        assert torch.equal(a, b), path
    lenet = acc.make_env("lenet", "cpu")
    for k, v in init_lenet(seed=0, device="cpu").items():
        assert torch.equal(lenet.params[k], v), k
    payload = acc.build_matrix(time_cells=False, log=lambda s: None,
                               device="cpu")
    assert acc.floor_fails(payload) == []


def _items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    else:
        yield path, tree
