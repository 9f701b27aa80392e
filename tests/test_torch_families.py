"""The five payload families the port adds — perchannel, bfp8, int2,
actsparse, gsparse — vs the JAX reference, on identical numpy inputs.

* compiled leaves and payloads equal the reference's byte for byte, at 8,
  4 and 2 bits where the family takes a bit-width;
* ``payload_dispatch`` / ``linear_dispatch`` on the CPU within f32
  ``rtol=1e-5, atol=1e-5`` of the reference's jnp dispatch (the two sum K
  products in different orders), actsparse under a ReLU with tau > 0;
* a checkpoint round trip keeps every leaf's bytes;
* the corruption cases of ``tests/test_family_corruption.py`` raise a
  ``ValueError`` that leads with the family's name, over the port's whole
  registry;
* the registry holds the reference's ten families in the reference's
  order;
* ``gpu``-marked cases hold each family's kernel route against its plain
  version on a card, and skip without one.
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
from repro.core.families import gsparse as jgs  # noqa: E402
from repro.models import lenet as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ArchConfig as JCfg  # noqa: E402
from repro.train.checkpoint import Checkpointer as JCk  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.models import lenet as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.config import ArchConfig as TCfg  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer as TCk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NEW = ("perchannel", "bfp8", "int2", "actsparse", "gsparse")
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
           param_dtype="float32", tie_embeddings=True)
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("wg", "wu", "wd")
TAU = 0.05


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 \
            else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable host copy


def _assert_trees_equal(ttree, jtree):
    jl_, tl_ = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(tl_) == sorted(jl_)
    for path, a in jl_.items():
        a, b = _as_np(a), _as_np(tl_[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


# ----------------------------------------------------------- registration


def test_registration_order_is_the_references():
    names = [f.name for f in treg.all_families()]
    assert names == [f.name for f in jreg.all_families()] == [
        "sparse_packed", "sparse", "int2", "quant_packed", "quant",
        "gsparse", "perchannel", "bfp8", "actsparse", "dense"]
    for name in NEW:
        assert name in names
    # the shared scale leaf resolves as the reference resolves it
    for leaf in ("w_s", "w_q2", "w_pcs", "w_bfpe", "w_atau", "w_grp", "w"):
        assert treg.family_for_leaf_name(leaf).name == \
            jreg.family_for_leaf_name(leaf).name
    assert treg.family_for_leaf_name("b") is None
    # every container leaf the reference names, plus the int8 codes and
    # the block container of the new families, which a checkpoint must
    # store verbatim
    assert set(jreg.container_leaf_names()) < \
        set(treg.container_leaf_names())
    assert {"w_q2", "w_pc", "w_bfp", "w_ablk"} <= \
        set(treg.container_leaf_names())


def test_registration_order_resolves_each_payload_to_its_family():
    """perchannel, bfp8 and int2 payloads all hold 2-d integer codes and a
    small scale leaf: the walk front to back must land each on its own
    family, as the reference's does."""
    w = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    tp = {"w": w}
    for pol, bits in (("perchannel", 8), ("bfp8", 8), ("quant", 2),
                      ("quant", 4), ("quant", 8)):
        kw = dict(block=(8, 4), min_weight_elems=0, quant_bits=bits)
        jpl = jc.compile_conv(w.reshape(1, 1, 32, 16), policy=pol,
                              rules=jc.CompileRules(**kw))[0].payload
        tpl = tc.compile_conv(tp["w"].reshape(1, 1, 32, 16), policy=pol,
                              rules=tc.CompileRules(**kw),
                              device="cpu")[0].payload
        assert treg.family_of_payload(tpl).name == \
            jreg.family_of_payload(jpl).name
        assert treg.unwrap_payload(tpl)[0].name == \
            jreg.unwrap_payload(jpl)[0].name


# ------------------------------------------------------- compile, leaves

MODEL_CASES = {
    "perchannel8": (dict(quant_bits=8), {k: "perchannel" for k in ATTN + MLP}),
    "perchannel4": (dict(quant_bits=4), {k: "perchannel" for k in ATTN + MLP}),
    "perchannel2": (dict(quant_bits=2), {k: "perchannel" for k in ATTN + MLP}),
    "bfp8": (dict(quant_bits=8), {k: "bfp8" for k in ATTN + MLP}),
    "bfp8_at_2": (dict(quant_bits=2), {k: "bfp8" for k in ATTN + MLP}),
    "int2": (dict(quant_bits=2), {k: "quant" for k in ATTN + MLP}),
    "int2_sparse": (dict(quant_bits=2), {k: "sparse" for k in ATTN + MLP}),
    "actsparse": (dict(act_threshold=TAU), {k: "actsparse" for k in MLP}),
    "actsparse_bf16": (dict(act_threshold=TAU, dtype="bfloat16"),
                       {k: "actsparse" for k in ATTN + MLP}),
    "family_map": (dict(quant_bits=8, act_threshold=TAU),
                   {"wq": "perchannel", "wo": "perchannel", "wk": "bfp8",
                    "wv": "bfp8", "wg": "actsparse", "wu": "actsparse",
                    "wd": "actsparse"}),
}


def _rules(case):
    kw, pols = MODEL_CASES[case]
    kw = dict(block=(32, 32), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, policies=pols, **kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("dtype") == "bfloat16":
        jkw["dtype"], tkw["dtype"] = jnp.bfloat16, torch.bfloat16
    return jc.CompileRules(**jkw), tc.CompileRules(**tkw)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_compile_model_family_leaves_match_reference(models, case):
    jcfg, tcfg, jp, tp = models
    jr, tr = _rules(case)
    jcm = jc.compile_model(jp, jcfg, rules=jr)
    tcm = tc.compile_model(tp, tcfg, rules=tr, device="cpu")
    _assert_trees_equal(tcm.params, jcm.params)
    rows = lambda cm: [(r.name, r.policy, r.compressed_bytes,
                        r.container_bytes, r.block_density,
                        r.element_density) for r in cm.report]
    assert rows(tcm) == rows(jcm)
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    # the dense oracle reconstructs the same weights
    _assert_trees_equal(tc.decompress_model(tcm), jc.decompress_model(jcm))


@pytest.mark.parametrize("case", ["family_map", "int2", "int2_sparse",
                                  "perchannel4", "actsparse"])
def test_compiled_decode_step_matches_reference(models, case):
    jcfg, tcfg, jp, tp = models
    jr, tr = _rules(case)
    jcm = jc.compile_model(jp, jcfg, rules=jr)
    tcm = tc.compile_model(tp, tcfg, rules=tr, device="cpu")
    B = 2
    toks = np.random.default_rng(1).integers(0, 64, (B, 8)).astype(np.int32)
    jcache, tcache = jm.init_cache(jcfg, B, 16, kv_cache="int4x2"), \
        tm.init_cache(tcfg, B, 16, kv_cache="int4x2", device="cpu")
    jlog, jcache = jm.prefill_step(jcm.params, jcfg, jcache,
                                   jnp.asarray(toks), patterns=jcm.patterns,
                                   dispatch="jnp", t_bound=16, bt=8)
    tlog, tcache = tm.prefill_step(tcm.params, tcfg, tcache,
                                   torch.from_numpy(toks),
                                   patterns=tcm.patterns, t_bound=16, bt=8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for step in range(2):
        tok = toks[:, step:step + 1]
        jlog, jcache = jm.decode_step(jcm.params, jcfg, jcache,
                                      jnp.asarray(tok), patterns=jcm.patterns,
                                      dispatch="jnp", t_bound=16, bt=8)
        tlog, tcache = tm.decode_step(tcm.params, tcfg, tcache,
                                      torch.from_numpy(tok),
                                      patterns=tcm.patterns, t_bound=16, bt=8)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


# ------------------------------------------------------ payloads, dispatch

# (policy, bits, K, N, block): K % 4 != 0 takes int2's unpack path and an
# int2x4 container packed along N (the quant family's), as the reference
PAYLOAD_CASES = [
    ("perchannel", 8, 96, 64, (8, 4)), ("perchannel", 4, 96, 64, (8, 4)),
    ("perchannel", 2, 96, 64, (8, 4)), ("bfp8", 8, 96, 64, (8, 4)),
    ("bfp8", 2, 96, 64, (8, 4)), ("quant", 2, 96, 64, (8, 4)),
    ("quant", 2, 25, 6, (5, 2)), ("quant", 2, 150, 16, (10, 4)),
    ("quant", 2, 26, 10, (2, 2)), ("sparse", 2, 96, 64, (8, 4)),
    ("actsparse", 8, 96, 64, (8, 4)), ("actsparse", 8, 150, 16, (10, 4)),
]


def _payload_pair(policy, bits, K, N, block, seed=0, tau=TAU):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = rng.random(size=(K, N)) < 0.6
    kw = dict(block=block, min_weight_elems=0, quant_bits=bits,
              act_threshold=tau)
    jcp, jpat, jrep = jc.compile_conv(w.reshape(1, 1, K, N), mask=mask,
                                      policy=policy,
                                      rules=jc.CompileRules(**kw))
    tcp, tpat, trep = tc.compile_conv(w.reshape(1, 1, K, N), mask=mask,
                                      policy=policy,
                                      rules=tc.CompileRules(**kw),
                                      device="cpu")
    return jcp.payload, tcp.payload, jrep, trep


@pytest.mark.parametrize("policy,bits,K,N,block", PAYLOAD_CASES)
def test_payloads_and_dispatch_match_reference(policy, bits, K, N, block):
    jp, tp, jrep, trep = _payload_pair(policy, bits, K, N, block)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    jf, jleaves, jpat = jreg.unwrap_payload(jp)
    tf, tleaves, tpat = treg.unwrap_payload(tp)
    assert tf.name == jf.name
    _assert_trees_equal(tleaves, jleaves)
    if jpat is not None:
        for f in ("bitmap", "block_rows", "block_cols"):
            np.testing.assert_array_equal(getattr(tpat, f),
                                          getattr(jpat, f))
    np.testing.assert_array_equal(tf.payload_dense(tp).numpy(),
                                  np.asarray(jf.payload_dense(jp)))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, K)).astype(np.float32)
    b = (rng.normal(size=N) / 4).astype(np.float32)
    for act in (None, "relu", "silu"):
        want = jd.payload_dispatch(jp, jnp.asarray(x), dispatch="jnp",
                                   bias=jnp.asarray(b), activation=act)
        for mode in ("auto", "twin"):
            got = td.payload_dispatch(tp, _t(x), dispatch=mode, bias=_t(b),
                                      activation=act)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{policy} {act} {mode}")


def test_actsparse_relu_is_the_threshold_relu():
    """With tau > 0 a following ReLU zeroes the small positives too, on
    the payload (fused trelu) and on compiled leaves (the where after the
    product), and it equals the reference's either way."""
    jp, tp, _, _ = _payload_pair("actsparse", 8, 96, 64, (8, 4), tau=0.5)
    x = np.random.default_rng(2).normal(size=(7, 96)).astype(np.float32)
    y = td.payload_dispatch(tp, _t(x), activation="relu")
    plain = td.payload_dispatch(tp, _t(x), activation=None)
    small = (plain > 0) & (plain <= 0.5)
    assert bool(small.any()) and bool((y[small] == 0).all())
    torch.testing.assert_close(y[plain > 0.5], plain[plain > 0.5], rtol=0,
                               atol=0)
    want = jd.payload_dispatch(jp, jnp.asarray(x), dispatch="jnp",
                               activation="relu")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    # a threshold that is a tensor leaf (a compiled model's) takes the
    # where after the product: the same values
    _, leaves, pat = treg.unwrap_payload(tp)
    y2 = td.linear_dispatch({**leaves, "w_atau": leaves["w_atau"][None][0]},
                            _t(x), pattern=pat, activation="relu")
    np.testing.assert_allclose(y2.numpy(), y.numpy(), rtol=0, atol=0)


def test_compile_lenet_with_family_payloads_matches_reference():
    jparams = {k: np.asarray(v)
               for k, v in jl.init_lenet(jax.random.PRNGKey(0)).items()}
    tparams = interop.params_from_numpy(jparams, "cpu")
    blocks = {"fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2), "conv1": (5, 2),
              "conv2": (10, 4)}
    pols = {"conv1": "quant", "conv2": "quant", "fc1": "perchannel",
            "fc2": "bfp8", "fc3": "actsparse"}
    kw = dict(block=(8, 4), min_weight_elems=0, quant_bits=2,
              act_threshold=TAU, policies=pols)
    jcm = jc.compile_lenet(jparams, rules=jc.CompileRules(**kw),
                           blocks=blocks)
    tcm = tc.compile_lenet(tparams, rules=tc.CompileRules(**kw),
                           blocks=blocks, device="cpu")
    assert [(r.name, r.policy, r.compressed_bytes, r.container_bytes)
            for r in tcm.report] == \
        [(r.name, r.policy, r.compressed_bytes, r.container_bytes)
         for r in jcm.report]
    x = np.random.default_rng(4).normal(size=(3, 28, 28, 1)).astype(
        np.float32)
    want = jl.lenet_forward(jparams, jnp.asarray(x), compressed=jcm.layers,
                            dispatch="jnp")
    for fusion in (True, None):
        got = tl.lenet_forward(tparams, _t(x), compressed=tcm.layers,
                               fusion=fusion)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------- gsparse


@pytest.mark.parametrize("init", ["gsparse", "gsparse_int8"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_gsparse_matches_reference_on_its_init_leaves(init, s):
    K, N = 32, 48
    fn = jgs._init_gsparse if init == "gsparse" else jgs._init_gsparse_int8
    jleaves = fn(jax.random.PRNGKey(s), K, N, dtype=jnp.float32, pattern=s)
    tleaves = {k: _t(np.asarray(v)) for k, v in jleaves.items()}
    rng = np.random.default_rng(s)
    x = rng.normal(size=(3, 5, K)).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    for act in (None, "gelu"):
        want = jd.linear_dispatch({**jleaves, "b": jnp.asarray(b)},
                                  jnp.asarray(x), dispatch="jnp",
                                  activation=act)
        got = td.linear_dispatch({**tleaves, "b": _t(b)}, _t(x),
                                 activation=act)
        assert tuple(got.shape) == (3, 5, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert treg.validate_leaves(tleaves).name == "gsparse"


# ------------------------------------------------------------ checkpoint


@pytest.mark.parametrize("case", ["perchannel4", "bfp8", "int2",
                                  "actsparse", "actsparse_bf16"])
def test_checkpoint_round_trip_keeps_every_leaf(models, case, tmp_path):
    jcfg, tcfg, jp, tp = models
    _, tr = _rules(case)
    tcm = tc.compile_model(tp, tcfg, rules=tr, device="cpu")
    state = {"params": tcm.params}
    ck = TCk(str(tmp_path / "port"))
    if case == "actsparse_bf16":
        # a bf16 block container would need widening: refused, not cast
        with pytest.raises(TypeError, match="w_ablk"):
            ck.save(1, state)
        return
    ck.save(1, state)
    out, manifest = ck.restore(state)
    assert manifest["step"] == 1
    _assert_trees_equal(out["params"], tcm.params)
    # the reference reads the port's checkpoint to the same bytes
    def to_jax(v):  # the same leaf as a reference template
        if v.dtype == torch.bfloat16:
            return np.asarray(v.float().numpy()).astype(jnp.bfloat16)
        return v.numpy()

    jout, _ = JCk(str(tmp_path / "port")).restore(jax.tree_util.tree_map(
        to_jax, state, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    _assert_trees_equal(out["params"], jout["params"])


# ------------------------------------------------------------ corruption

FAMILIES = treg.all_families()
IDS = [f.name for f in FAMILIES]
_TRUNCATION = {
    "sparse": "pattern", "sparse_packed": "pattern", "actsparse": "pattern",
    "quant": "n", "quant_packed": "n", "int2": "n", "bfp8": "n",
    "perchannel": "k", "gsparse": "groups", "dense": "ndim",
}
_STALE_LEAF = {
    "quant": "w_s", "quant_packed": "w_s", "int2": "w_s",
    "bfp8": "w_bfpe", "perchannel": "w_pcs", "gsparse": "w_s",
    "actsparse": "w_atau",
}


def _sampled(fam):
    leaves, pattern = fam.sample(np.random.default_rng(0))
    return dict(leaves), pattern


def _dispatch(leaves, pattern):
    fam = treg.family_for_leaves(leaves)
    key = leaves[fam.key_leaf]
    K = pattern.shape[0] if pattern is not None else (
        16 if fam.name != "gsparse" else key.shape[0] * key.shape[1])
    return td.linear_dispatch(leaves, torch.zeros((2, K)), pattern=pattern,
                              dispatch="twin")


def _gsparse_with_scales(leaves):
    s, _, ng = leaves["w_grp"].shape
    leaves["w_s"] = torch.ones((s * ng,), dtype=torch.float32)
    return leaves


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_wrong_dtype_on_key_leaf_is_family_named_error(fam):
    leaves, pattern = _sampled(fam)
    v = leaves[fam.key_leaf]
    allowed = fam.leaf_dtype_kinds.get(fam.key_leaf) or \
        treg.dtype_kind(v.dtype)
    bad = next(dt for dt, kind in ((torch.float32, "f"), (torch.int8, "i"),
                                   (torch.uint8, "u")) if kind not in allowed)
    leaves[fam.key_leaf] = v.to(bad)
    with pytest.raises(ValueError, match=rf"^{fam.name} payload"):
        _dispatch(leaves, pattern)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_truncated_axis_is_family_named_error(fam):
    leaves, pattern = _sampled(fam)
    mode, key = _TRUNCATION[fam.name], fam.key_leaf
    v = leaves[key]
    if mode == "pattern":
        leaves[key] = v[:-1]
    elif mode == "n":
        leaves[key] = v[..., :-1]
    elif mode == "k":
        leaves[key] = v[..., :-1, :]
    elif mode == "groups":
        leaves = _gsparse_with_scales(leaves)
        leaves[key] = v[..., :-1]
    else:
        leaves[key] = v[0]
    with pytest.raises(ValueError, match=rf"^{fam.name} payload"):
        _dispatch(leaves, pattern)


@pytest.mark.parametrize("fam", [f for f in FAMILIES
                                 if f.name in _STALE_LEAF],
                         ids=[f.name for f in FAMILIES
                              if f.name in _STALE_LEAF])
def test_stale_scale_shape_is_family_named_error(fam, tmp_path):
    leaves, pattern = _sampled(fam)
    if fam.name == "gsparse":
        leaves = _gsparse_with_scales(leaves)
    name = _STALE_LEAF[fam.name]
    good = leaves[name]
    leaves[name] = torch.zeros((3, 3)) if fam.name == "actsparse" \
        else torch.cat([good, good])
    with pytest.raises(ValueError, match=rf"^{fam.name} payload"):
        _dispatch(leaves, pattern)
    # a checkpoint keeps the bytes it is given: the first dispatch after a
    # restore still refuses them by name
    state = {"layer": leaves}
    ck = TCk(str(tmp_path / fam.name))
    ck.save(1, state)
    out, _ = ck.restore(state)
    with pytest.raises(ValueError, match=rf"^{fam.name} payload"):
        _dispatch(dict(out["layer"]), pattern)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_every_clean_sample_validates_and_dispatches(fam):
    leaves, pattern = _sampled(fam)
    assert treg.validate_leaves(leaves, pattern) is fam
    y = _dispatch(leaves, pattern)
    assert bool(torch.isfinite(y).all())


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy,bits,K,N,block", PAYLOAD_CASES)
def test_family_kernel_route_matches_plain_version(cuda_device, policy, bits,
                                                   K, N, block):
    from repro_torch.kernels import launch_counts

    _, tp, _, _ = _payload_pair(policy, bits, K, N, block)
    cp = tc._payload_to(tp, cuda_device)
    x = torch.randn((8, K), device=cuda_device)
    for act in (None, "relu"):
        before = launch_counts()
        y = td.payload_dispatch(cp, x, activation=act)
        moved = {k: v - before[k] for k, v in launch_counts().items()}
        kernel = "sparse_matmul" if policy in ("sparse", "actsparse") \
            else "quant_matmul"
        assert moved[f"{kernel}.kernel:launches"] == 1, moved
        ref = td.payload_dispatch(cp, x, activation=act, dispatch="twin")
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
