"""Port compile pass, payload registry and dispatch vs the JAX reference.

``compile_model`` must give the reference's leaves, patterns and report
bytes exactly (same numpy inputs); ``linear_dispatch`` must agree per
family with the reference's jnp path within f32 tolerance
(``rtol=1e-5, atol=1e-5``: the two sum K products in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ArchConfig as JCfg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core import sparsity as ts  # noqa: E402
from repro_torch.models.config import ArchConfig as TCfg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
           param_dtype="float32", tie_embeddings=True)
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("wg", "wu", "wd")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _as_np(v):
    """Host array; bfloat16 (no numpy dtype of its own) as its int16 bits."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 \
            else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


RULES = {
    "int4_serve": dict(block=(32, 32), block_density=0.25,
                       in_block_density=0.5, min_weight_elems=0, quant_bits=4,
                       policies={**{k: "quant" for k in ATTN},
                                 **{k: "sparse" for k in MLP}}),
    "int8": dict(block=(32, 32), block_density=0.5, quant_bits=8,
                 min_weight_elems=0,
                 policies={**{k: "sparse" for k in ATTN},
                           **{k: "quant" for k in MLP}}),
    "float_sparse": dict(block=(32, 32), block_density=0.5,
                         quantize_sparse=False, min_weight_elems=0,
                         policies={"wq": "dense", "wk": "dense", "wv": "dense",
                                   "wo": "sparse", "wg": "sparse",
                                   "wu": "dense", "wd": "sparse"}),
    "int2_sparse": dict(block=(16, 32), block_density=0.5, quant_bits=2,
                        min_weight_elems=0,
                        policies={**{k: "dense" for k in ATTN},
                                  **{k: "sparse" for k in MLP}}),
    "small_dense": dict(min_weight_elems=1 << 20),
}


def _compile_both(models, name, masks=None):
    jcfg, tcfg, jp, tp = models
    kw = dict(RULES[name])
    jrules = jc.CompileRules(**kw)
    if "dtype" not in kw:
        kw["dtype"] = torch.float32
    trules = tc.CompileRules(**kw)
    jcm = jc.compile_model(jp, jcfg, rules=jrules, masks=masks)
    tcm = tc.compile_model(tp, tcfg, rules=trules, masks=masks, device="cpu")
    return jcm, tcm


@pytest.mark.parametrize("name", list(RULES))
def test_compile_model_matches_reference(models, name):
    masks = None
    if name == "int8":
        rng = np.random.default_rng(0)
        masks = {"wd": rng.random((2, 128, 64)) < 0.3,
                 "blocks/attn/wq": rng.random((64, 64)) < 0.5}
    jcm, tcm = _compile_both(models, name, masks)
    jl, tl = dict(_leaves(jcm.params)), dict(_leaves(tcm.params))
    assert sorted(jl) == sorted(tl)
    for path, a in jl.items():
        a, b = _as_np(a), _as_np(tl[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    assert sorted(jcm.patterns) == sorted(tcm.patterns)
    for kn, pa in jcm.patterns.items():
        pb = tcm.patterns[kn]
        assert (pa.block, pa.nnz) == (pb.block, pb.nnz)
        for f in ("bitmap", "block_rows", "block_cols"):
            np.testing.assert_array_equal(getattr(pb, f), getattr(pa, f))
    rows = lambda cm: [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
                        r.compressed_bytes, r.container_bytes,
                        r.block_density, r.element_density)
                       for r in cm.report]
    assert rows(tcm) == rows(jcm)
    assert (tcm.storage_bytes, tcm.container_storage_bytes,
            tcm.dense_bytes) == (jcm.storage_bytes,
                                 jcm.container_storage_bytes, jcm.dense_bytes)
    assert tcm.byte_compression == jcm.byte_compression
    # the dense oracle reconstructs the same weights
    jdm = jc.decompress_model(jcm)
    tdm = tc.decompress_model(tcm)
    for path, a in _leaves(jdm):
        np.testing.assert_array_equal(_as_np(dict(_leaves(tdm))[path]),
                                      _as_np(a), err_msg=str(path))


def test_compile_model_errors(models):
    jcfg, tcfg, jp, tp = models
    # no policies entry: the cost model picks, as the reference's does
    kw = dict(min_weight_elems=0)
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw))
    tcm = tc.compile_model(tp, tcfg, rules=tc.CompileRules(**kw),
                           device="cpu")
    assert [(r.name, r.policy) for r in tcm.report] == \
        [(r.name, r.policy) for r in jcm.report]
    # "autotune" takes tuned_policy's pick, the reference's
    kw = dict(policies={"wq": "autotune"}, min_weight_elems=1 << 20)
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw))
    tcm = tc.compile_model(tp, tcfg, device="cpu",
                           rules=tc.CompileRules(**kw))
    assert [(r.name, r.policy, r.container_bytes) for r in tcm.report] == \
        [(r.name, r.policy, r.container_bytes) for r in jcm.report]
    with pytest.raises(ValueError, match="unknown policy"):
        tc.compile_model(tp, tcfg, device="cpu", rules=tc.CompileRules(
            policies={"wq": "perchannel8"}, min_weight_elems=1 << 20))
    with pytest.raises(ValueError, match="policies keys matched no"):
        tc.compile_model(tp, tcfg, device="cpu", rules=tc.CompileRules(
            policies={"wz": "quant"}, min_weight_elems=1 << 20))
    with pytest.raises(ValueError, match="masks keys matched no"):
        tc.compile_model(tp, tcfg, device="cpu", masks={"w_q": np.ones(1)},
                         rules=tc.CompileRules(min_weight_elems=1 << 20))
    cm = tc.compile_model(tp, tcfg, device="cpu",
                          rules=tc.CompileRules(**RULES["int4_serve"]))
    with pytest.raises(ValueError, match="already compiled"):
        tc.compile_model(cm.params, tcfg, device="cpu",
                         rules=tc.CompileRules(**RULES["int4_serve"]))
    # quant at 2 bits: the int2 family's int2x4 container
    cm2 = tc.compile_model(tp, tcfg, device="cpu", rules=tc.CompileRules(
        quant_bits=2, min_weight_elems=0,
        policies={k: "quant" for k in ATTN + MLP}))
    assert all(set(leaf) >= {"w_q2", "w_s"} for _, leaf, _ in (
        (p, par[k], k) for p, par, k in tc._iter_linears(
            cm2.params["blocks"], "blocks")))
    # the SSM family is refused, with the reference's message; the hybrid
    # lowers its shared attention and head (none here), never ``blocks``
    with pytest.raises(NotImplementedError,
                       match="supports attention/MLP families, got ssm"):
        tc.compile_model(tp, dataclasses.replace(tcfg, family="ssm"),
                         device="cpu")
    hy = tc.compile_model(tp, dataclasses.replace(tcfg, family="hybrid"),
                          device="cpu")
    assert [r.name for r in hy.report if r.name != "head"] == [
        "blocks (ssm, not lowered)"]


# ---------------------------------------------------------------- dispatch


def _dispatch_cases(models):
    """(name, leaves as numpy, pattern table key) from compiled models."""
    cases = []
    for rules in ("int4_serve", "int8", "float_sparse", "int2_sparse"):
        jcm, _ = _compile_both(models, rules)
        blocks = jcm.params["blocks"]
        for sub, keys in (("attn", ATTN), ("mlp", MLP)):
            for k in keys:
                leaf = {n: np.asarray(v)[0] for n, v in blocks[sub][k].items()}
                fam = jreg.family_for_leaves(leaf).name
                shape = jcm.policy_of(f"blocks/{sub}/{k}")
                cases.append((fam, leaf, jcm, f"blocks/{sub}/{k}", shape))
    seen, out = set(), []
    for c in cases:
        if c[0] not in seen:
            seen.add(c[0])
            out.append(c)
    return out


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_linear_dispatch_per_family_matches_reference(models, act):
    cases = _dispatch_cases(models)
    assert {c[0] for c in cases} == {"dense", "quant", "quant_packed", "sparse",
                                     "sparse_packed"}
    rng = np.random.default_rng(1)
    for fam, leaf, jcm, path, _ in cases:
        K, N = [r.shape for r in jcm.report if r.name == path][0]
        pat_j = jcm.patterns.get((K, N))
        pat_t = None if pat_j is None else ts.pattern_from_bitmap(
            (K, N), pat_j.block, pat_j.bitmap)
        x = rng.normal(size=(3, 5, K)).astype(np.float32)
        b = rng.normal(size=N).astype(np.float32)
        ref = jd.linear_dispatch({**{k: jnp.asarray(v) for k, v in leaf.items()},
                                  "b": jnp.asarray(b)}, jnp.asarray(x),
                                 pattern=pat_j, dispatch="jnp", activation=act)
        p = {**{k: torch.from_numpy(v.copy()) for k, v in leaf.items()},
             "b": torch.from_numpy(b)}
        for mode in ("auto", "twin"):
            y = td.linear_dispatch(p, torch.from_numpy(x), pattern=pat_t,
                                   dispatch=mode, activation=act,
                                   leaf=path)
            assert treg.family_for_leaves(p).name == fam
            np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL,
                                       err_msg=f"{fam} {mode}")
        if fam != "dense":  # dense is a plain matmul in every mode
            with pytest.raises(ValueError, match="kernel"):
                td.linear_dispatch(p, torch.from_numpy(x), pattern=pat_t,
                                   dispatch="kernel", leaf=path)


def test_odd_k_quant_packed_and_payload_dispatch():
    rng = np.random.default_rng(2)
    K, N = 7, 6
    w = rng.normal(size=(K, N)).astype(np.float32)
    qt = tq.quantize(torch.from_numpy(w), 4, axis=1)
    pt = tq.PackedTensor(data=tq.pack_int4(qt.values, axis=0), shape=(K, N),
                         axis=0, scales=qt.scales, bits=4)
    x = torch.from_numpy(rng.normal(size=(4, K)).astype(np.float32))
    want = x @ (qt.values.float() * qt.scales[None, :])
    for payload in (pt, qt, tq.pack_quantized(qt)):
        y = td.payload_dispatch(payload, x)
        np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    y = td.linear_dispatch({"w_qp": pt.data, "w_s": qt.scales}, x)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    dense = td.payload_dispatch(torch.from_numpy(w), x,
                                bias=torch.ones(N), activation="relu")
    np.testing.assert_allclose(dense.numpy(),
                               torch.relu(x @ torch.from_numpy(w) + 1).numpy(),
                               **TOL)
    # a sparse payload through its family
    mask = np.ones((8, 6), bool)
    mask[4:, 3:] = False
    cl = ts.compress(rng.normal(size=(8, 6)).astype(np.float32), mask, (4, 3),
                     dtype=torch.float32)
    x8 = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    np.testing.assert_allclose(td.payload_dispatch(cl, x8).numpy(),
                               (x8 @ ts.decompress(cl)).numpy(), **TOL)
    with pytest.raises(TypeError, match="no registered payload family"):
        td.payload_dispatch(object(), x)


def test_validate_leaves_names_the_family(models):
    jcm, tcm = _compile_both(models, "int4_serve")
    pat = next(iter(tcm.patterns.values()))
    blk = tcm.params["blocks"]["mlp"]["wd"]
    qp = tcm.params["blocks"]["attn"]["wq"]
    bad = [
        ({"w_qp": qp["w_qp"][0].to(torch.float32), "w_s": qp["w_s"][0]},
         None, "quant_packed payload: leaf 'w_qp' has dtype"),
        ({"w_qp": qp["w_qp"][0], "w_s": qp["w_s"][0][:-1]}, None,
         "quant_packed payload: scale leaf"),
        ({"w_blkp": blk["w_blkp"][0][:-1], "w_s": blk["w_s"][0]},
         tcm.patterns[(128, 64)], "sparse_packed payload: block leaf"),
        ({"w_q": torch.zeros(2, 3, 4, 5, dtype=torch.int8)}, None,
         "quant payload: leaf 'w_q' has ndim"),
    ]
    del pat
    for p, pattern, msg in bad:
        with pytest.raises(ValueError, match=msg):
            treg.validate_leaves(p, pattern)
    assert treg.validate_leaves({"b": torch.ones(2)}) is None
    assert treg.validate_leaves(
        {"w_blkp": blk["w_blkp"][0], "w_s": blk["w_s"][0]},
        tcm.patterns[(128, 64)]).name == "sparse_packed"


def test_registry_queries():
    assert treg.weight_leaf_names() == jreg.weight_leaf_names() == (
        "w_blkp", "w_blk", "w_q2", "w_qp", "w_q", "w_grp", "w_pc", "w_bfp",
        "w_ablk", "w")
    assert [f.name for f in treg.all_families()] == [
        f.name for f in jreg.all_families()]
    for f in treg.all_families():
        j = jreg.get(f.name)  # the reference family of the same name
        assert (f.key_leaf, f.leaf_names, f.needs_pattern, f.leaf_ndim,
                f.kind, f.container, f.code_leaf) == \
            (j.key_leaf, j.leaf_names, j.needs_pattern, dict(j.leaf_ndim),
             j.kind, j.container, j.code_leaf)
    assert treg.pattern_leaf({"w_blk": None}) and not treg.pattern_leaf({"w": 1})
    assert treg.policy_names() == jreg.policy_names() == (
        "actsparse", "bfp8", "perchannel", "quant", "sparse")
    assert treg.policy_eliminates_blocks("sparse")
    assert treg.policy_eliminates_blocks("actsparse")
    assert not treg.policy_eliminates_blocks("quant")
    assert not treg.policy_eliminates_blocks("dense")
    with pytest.raises(KeyError, match="no registered policy"):
        treg.policy_compiler("gsparse")
    with pytest.raises(ValueError, match="already registered"):
        treg.register(treg.all_families()[-1])


def test_dispatch_modes_and_env(monkeypatch):
    monkeypatch.delenv(td.DISPATCH_ENV, raising=False)
    assert td.resolve().mode == "auto"
    monkeypatch.setenv(td.DISPATCH_ENV, "twin")
    assert td.resolve().mode == "twin"
    assert td.resolve("KERNEL").mode == "kernel"
    monkeypatch.setenv(td.DISPATCH_ENV, "pallas")
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        td.resolve()
    assert td.DISPATCH_ENV != jd.DISPATCH_ENV
    assert td.attn_packed_eligible(64, 64) and not td.attn_packed_eligible(63, 64)
