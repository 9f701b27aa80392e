"""The LeNet-5 Table-I slice of the port vs the JAX reference, on identical
numpy inputs: the synthetic digits, ``compile_lenet`` (byte-equal payloads,
patterns and report bytes, equal fusion plan), ``lenet_forward`` fused and
layer by layer, and weights carried across with ``params_from_numpy``.

The JAX fused forward runs its Pallas kernels in interpret mode
(``dispatch="pallas"``), the layer-by-layer one its jnp twins
(``dispatch="jnp"``); the port runs on the CPU, where every wrapper takes
its plain version.  Tolerance: f32 ``rtol=1e-5, atol=1e-6`` (only the order
of summation differs).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_sparse as jc  # noqa: E402
from repro.data.synthetic import synthetic_digits as j_digits  # noqa: E402
from repro.models import lenet as jl  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core.quant import fake_quant  # noqa: E402
from repro_torch.data.synthetic import synthetic_digits as t_digits  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import fc_stack as tfk  # noqa: E402
from repro_torch.models import lenet as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = [n for n, _, _ in tl.LAYERS]
# benchmarks/table1_lenet.py:85-87 and :105-106
BLOCKS = {"fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2), "conv1": (5, 2),
          "conv2": (10, 4)}
WHOLE_MODEL = dict(block=(8, 4), min_weight_elems=0, quant_bits=4,
                   block_density=0.5, in_block_density=0.25)
RULES = {
    "table1": dict(WHOLE_MODEL, policies={n: "sparse" for n in NAMES}),
    "quant_conv": dict(WHOLE_MODEL, policies={
        **{n: "sparse" for n in NAMES}, "conv1": "quant", "conv2": "quant"}),
    "int8_masked": dict(block=(8, 4), min_weight_elems=0, quant_bits=8,
                        policies={"conv1": "sparse", "conv2": "quant",
                                  "fc1": "sparse", "fc2": "quant",
                                  "fc3": "dense"}),
    "dense_masked": dict(block=(8, 4), min_weight_elems=0,
                         policies={n: "dense" for n in NAMES}),
}


@pytest.fixture(scope="module")
def params():
    jp = jl.init_lenet(jax.random.PRNGKey(0))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    # non-zero biases, so the fused epilogues are exercised
    rng = np.random.default_rng(5)
    for name, _, shape in tl.LAYERS:
        npp[name + "_b"] = (rng.normal(size=shape[-1]) / 10).astype(np.float32)
    return npp


def _masks(seed=1):
    rng = np.random.default_rng(seed)
    return {name: rng.random(shape) < 0.5 for name, _, shape in tl.LAYERS}


def _compile_both(npp, rules_name):
    kw = dict(RULES[rules_name])
    masks = _masks() if rules_name.endswith("_masked") else None
    jcm = jc.compile_lenet({k: jax.numpy.asarray(v) for k, v in npp.items()},
                           masks, rules=jc.CompileRules(**kw), blocks=BLOCKS)
    tcm = tc.compile_lenet(params_from_numpy(npp, device="cpu"), masks,
                           rules=tc.CompileRules(**kw), blocks=BLOCKS,
                           device="cpu")
    return jcm, tcm


def _flat(p, prefix=""):
    """A payload object's arrays and static fields, by attribute path
    (ConvPayload / CompressedLinear / PackedTensor / QuantizedTensor /
    dense array — the same attribute names in both packages)."""
    if isinstance(p, (torch.Tensor, np.ndarray, jax.Array)):
        return {prefix + "w": p}
    if hasattr(p, "payload"):
        out = {prefix + f: getattr(p, f)
               for f in ("kernel", "strides", "padding", "dilation")}
        out.update(_flat(p.payload, prefix + "payload."))
        return out
    if hasattr(p, "pattern"):
        pat = p.pattern
        out = {prefix + "bits": p.bits, prefix + "scales": p.scales,
               prefix + "pattern.nnz": pat.nnz,
               prefix + "pattern.block": tuple(pat.block)}
        for f in ("bitmap", "block_rows", "block_cols"):
            out[prefix + "pattern." + f] = getattr(pat, f)
        out.update(_flat(p.blocks, prefix + "blocks."))
        return out
    if hasattr(p, "per_byte"):
        return {prefix + f: getattr(p, f) for f in
                ("data", "shape", "axis", "scales", "bits", "per_byte")}
    if hasattr(p, "values"):
        return {prefix + f: getattr(p, f)
                for f in ("values", "scales", "axis", "bits")}
    raise TypeError(f"unknown payload {type(p).__name__}")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("rules_name", list(RULES))
def test_compile_lenet_matches_reference_byte_for_byte(params, rules_name):
    jcm, tcm = _compile_both(params, rules_name)
    assert sorted(jcm.layers) == sorted(tcm.layers)
    for name, jp in jcm.layers.items():
        jf, tf = _flat(jp), _flat(tcm.layers[name])
        assert sorted(jf) == sorted(tf), name
        for k, a in jf.items():
            b = tf[k]
            if a is None or isinstance(a, (int, str, tuple)):
                assert b == a, f"{name}.{k}"
                continue
            a, b = np.asarray(a), _np(b)
            assert a.dtype == b.dtype, f"{name}.{k}"
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{k}")
    assert sorted(jcm.patterns) == sorted(tcm.patterns)
    rows = lambda cm: [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
                        r.compressed_bytes, r.container_bytes,
                        r.block_density, r.element_density, r.kind,
                        r.m_scale) for r in cm.report]
    assert rows(tcm) == rows(jcm)
    assert (tcm.storage_bytes, tcm.container_storage_bytes,
            tcm.byte_compression) == (jcm.storage_bytes,
                                      jcm.container_storage_bytes,
                                      jcm.byte_compression)
    assert tcm.fusion == jcm.fusion
    assert tc.realised_densities(tcm) == jc.realised_densities(jcm)
    jd, td_ = jc.decompress_model(jcm), tc.decompress_model(tcm)
    for name in NAMES:
        np.testing.assert_array_equal(_np(td_[name + "_w"]),
                                      np.asarray(jd[name + "_w"]),
                                      err_msg=name)


def test_table1_containers_are_the_references_choice(params):
    """conv1 (bk=5, odd) reaches the kernel as int8 codes, conv2 (bk=10)
    as its int4x2 container; under quant, conv1's K=25 is odd too."""
    _, tcm = _compile_both(params, "table1")
    c1, c2 = tcm.layers["conv1"].payload, tcm.layers["conv2"].payload
    assert c1.packed and c1.blocks.axis == 2        # bn-axis: unpacked
    assert c2.packed and c2.blocks.axis == 1 and c2.blocks.per_byte == 2
    _, qcm = _compile_both(params, "quant_conv")
    q1, q2 = qcm.layers["conv1"].payload, qcm.layers["conv2"].payload
    assert q1.axis == 1 and q2.axis == 0            # N-axis vs K-axis


@pytest.mark.parametrize("rules_name", ["table1", "quant_conv"])
def test_fused_forward_matches_reference_pallas_interpret(params, rules_name):
    jcm, tcm = _compile_both(params, rules_name)
    x = t_digits(0, noise=1.1).batch(0, 2)[0]
    want = jl.lenet_forward({k: jax.numpy.asarray(v)
                             for k, v in params.items()}, jax.numpy.asarray(x),
                            compressed=jcm.layers, fusion=True,
                            dispatch="pallas")
    tp = params_from_numpy(params, device="cpu")
    tfk.launches = 0
    got = tl.lenet_forward(tp, torch.from_numpy(x), compressed=tcm.layers,
                           fusion=True)
    assert tfk.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    twin = tl.lenet_forward(tp, torch.from_numpy(x), compressed=tcm.layers,
                            fusion=True, dispatch="twin")
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rules_name", list(RULES))
def test_unfused_forward_matches_reference_jnp(params, rules_name):
    jcm, tcm = _compile_both(params, rules_name)
    x = t_digits(0, noise=1.1).batch(1, 4)[0]
    want = jl.lenet_forward({k: jax.numpy.asarray(v)
                             for k, v in params.items()}, jax.numpy.asarray(x),
                            compressed=jcm.layers, dispatch="jnp")
    tp = params_from_numpy(params, device="cpu")
    for mode in ("auto", "twin"):
        got = tl.lenet_forward(tp, torch.from_numpy(x), compressed=tcm.layers,
                               dispatch=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_carried_params_give_the_same_masked_dense_forward(params):
    masks = _masks(2)
    x = t_digits(1).batch(2, 3)[0]
    want = jl.lenet_forward({k: jax.numpy.asarray(v)
                             for k, v in params.items()}, jax.numpy.asarray(x),
                            masks={k: jax.numpy.asarray(v)
                                   for k, v in masks.items()})
    got = tl.lenet_forward(params_from_numpy(params, device="cpu"),
                           torch.from_numpy(x),
                           masks=params_from_numpy(masks, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_synthetic_digits_match_the_reference_byte_for_byte():
    for seed in (0, 3):
        a, b = j_digits(seed, noise=1.1), t_digits(seed, noise=1.1)
        assert a.protos.tobytes() == b.protos.tobytes()
        # the batch seed hashes a str: equal only within one process
        xa, la = a.batch(4, 5, split="test")
        xb, lb = b.batch(4, 5, split="test")
        assert xa.tobytes() == xb.tobytes() and (la == lb).all()


def test_init_lenet_shapes_and_the_default_device(monkeypatch):
    p = tl.init_lenet(seed=3, device="cpu")
    for name, _, shape in tl.LAYERS:
        assert tuple(p[name + "_w"].shape) == shape
        assert p[name + "_w"].dtype == torch.float32
        assert not p[name + "_b"].any()
    q = tl.init_lenet(seed=3, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_lenet()


def test_lenet_forward_rejects_qat_bits(params):
    """``qat_bits`` was rejected until ``fake_quant`` was ported; now it
    fake-quantises the named dense layers' weights (the reference's QAT
    forward, held against ``repro`` in ``test_torch_train.py``)."""
    tp = params_from_numpy(params, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 28, 28, 1)).astype(np.float32))
    got = tl.lenet_forward(tp, x, qat_bits={"fc1": 4})
    fq = dict(tp, fc1_w=fake_quant(tp["fc1_w"], 4, axis=-1))
    torch.testing.assert_close(got, tl.lenet_forward(fq, x), rtol=0, atol=0)
    assert not torch.equal(got, tl.lenet_forward(tp, x))


def test_compile_lenet_errors(params):
    tp = params_from_numpy(params, device="cpu")
    with pytest.raises(ValueError, match="matched no LeNet layer"):
        tc.compile_lenet(tp, {"fc9": np.ones((2, 2), bool)}, device="cpu")
    # no policies entry: the cost model picks, as the reference's does
    jcm = jc.compile_lenet(params, rules=jc.CompileRules(min_weight_elems=0))
    tcm = tc.compile_lenet(tp, rules=tc.CompileRules(min_weight_elems=0),
                           device="cpu")
    assert [(r.name, r.policy) for r in tcm.report] == \
        [(r.name, r.policy) for r in jcm.report]
    with pytest.raises(ValueError, match="does not match the kernel"):
        tc.compile_lenet(tp, {"conv1": np.ones((5, 5, 1, 7), bool)},
                         rules=tc.CompileRules(**RULES["table1"]),
                         blocks=BLOCKS, device="cpu")
    rules = dataclasses.replace(tc.CompileRules(**RULES["table1"]),
                                quant_bits=2)
    # quant at 2 bits: fc1 (K = 256) in the int2 family's container
    cm2 = tc.compile_lenet(tp, rules=dataclasses.replace(
        rules, policies={**rules.policies, "fc1": "quant"}),
        blocks=BLOCKS, device="cpu")
    assert cm2.layers["fc1"].per_byte == 4 and cm2.layers["fc1"].axis == 0
