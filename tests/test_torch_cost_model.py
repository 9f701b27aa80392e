"""The port's cost model, folding, DSE and policy pick vs the JAX reference.

Both packages compute the roofline in plain Python float arithmetic, so
every estimate, folding and trace must be EQUAL, not close.  The compile
passes with no ``policies`` entry (``choose_policy`` under ``TPU_V5E``, the
default) must give the reference's per-leaf policies, leaf names and
containers byte for byte; their outputs agree within f32 ``rtol=1e-5,
atol=1e-6`` (only the order of summation differs).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import cost_model as jcm_  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro.core.folding import FoldingConfig as JFold  # noqa: E402
from repro.models import lenet as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ArchConfig as JCfg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import cost_model as tcm_  # noqa: E402
from repro_torch.core import dse as tdse  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.core.folding import FoldingConfig as TFold  # noqa: E402
from repro_torch.core.folding import UNROLL_LEVELS  # noqa: E402
from repro_torch.models import lenet as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.config import ArchConfig as TCfg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's HWSpec with the port's H100 figures: the reference's
# functions take any HWSpec, so both packages can be held on both machines
HWS = {"tpu_v5e": (jcm_.TPU_V5E, tcm_.TPU_V5E),
       "h100_sxm": (jcm_.HWSpec(**dataclasses.asdict(tcm_.H100_SXM)),
                    tcm_.H100_SXM)}
# benchmarks/table1_lenet.py:83-87, :105-106
BUDGET = 8e6
BLOCKS = {"fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2), "conv1": (5, 2),
          "conv2": (10, 4)}
WHOLE_MODEL_RULES = dict(block=(8, 4), min_weight_elems=0, quant_bits=4)
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
           param_dtype="float32", tie_embeddings=True)


def test_tpu_spec_is_the_reference_data_and_h100_is_opt_in():
    assert dataclasses.asdict(tcm_.TPU_V5E) == \
        dataclasses.asdict(jcm_.TPU_V5E)
    assert tc.CompileRules().hw is tcm_.TPU_V5E
    h = tcm_.H100_SXM
    assert (h.peak_flops_bf16, h.peak_flops_int8, h.hbm_bw) == \
        (989e12, 1979e12, 3.35e12)
    assert h.peak_flops(8) == h.peak_flops_int8
    assert h.peak_flops(16) == h.peak_flops_bf16
    assert UNROLL_LEVELS == ("folded", "factor", "sparse")


def _specs(cls):
    out = []
    for i, (kind, flops, wel, act, coll, bd, ed) in enumerate(
            itertools.product(("linear", "conv"), (2e6, 3.3e9),
                              (512, 4096 * 4096), (1e3, 4e6), (0.0, 2e6),
                              (1.0, 0.25), (1.0, 0.1))):
        out.append(cls(name=f"l{i}", kind=kind, flops=flops,
                       weight_elems=wel, act_bytes=act, coll_bytes=coll,
                       max_block_density=bd, max_element_density=ed))
    return out


def _folds(cls):
    return [cls(parallelism=p, unroll=u, block_density=bd,
                element_density=ed, quant_bits=b)
            for p, u, bd, ed, b in itertools.product(
                (1, 64, 4096), UNROLL_LEVELS, (1.0, 0.3), (1.0, 0.05),
                (4, 8, 16))]


@pytest.mark.parametrize("hw", list(HWS))
def test_layer_terms_equal_reference(hw):
    jhw, thw = HWS[hw]
    js, ts = _specs(jcm_.LayerSpec), _specs(tcm_.LayerSpec)
    jf, tf = _folds(JFold), _folds(TFold)
    for a, b in zip(js, ts):
        for fa, fb in zip(jf, tf):
            assert tcm_.layer_latency(b, fb, thw) == \
                jcm_.layer_latency(a, fa, jhw)
            assert tcm_.layer_resource(b, fb, thw) == \
                jcm_.layer_resource(a, fa, jhw)
    for n in (1, 7):
        je = jcm_.network_estimate(js[:n * 4], jf[:n * 4], jhw)
        te = tcm_.network_estimate(ts[:n * 4], tf[:n * 4], thw)
        assert dataclasses.asdict(te) == dataclasses.asdict(je)


@pytest.mark.parametrize("hw", list(HWS))
def test_tile_roofline_and_vmem_equal_reference(hw):
    jhw, thw = HWS[hw]
    for M, K, N, bm, bk, bn, nb, bits, launch in itertools.product(
            (1, 8, 512), (256, 2048), (512, 8192), (8, 128), (64, 128),
            (128, 256), (None, 5), (4, 8, 32), (True, False)):
        kw = dict(M=M, K=K, N=N, bm=bm, bk=bk, bn=bn, n_blocks=nb,
                  weight_bits=bits, launch=launch)
        assert tcm_.tile_roofline(**kw, hw=thw) == \
            jcm_.tile_roofline(**kw, hw=jhw)
        assert tcm_.tile_vmem_bytes(bm, bk, bn, x_bytes=bits // 8 or 1,
                                    w_bytes=1) == \
            jcm_.tile_vmem_bytes(bm, bk, bn, x_bytes=bits // 8 or 1,
                                 w_bytes=1)
    for K, N, bt in ((64, 128, 1), (2048, 8192, 512)):
        assert dataclasses.asdict(tcm_.decode_linear_spec(K, N, bt)) == \
            dataclasses.asdict(jcm_.decode_linear_spec(K, N, bt))


def _realised(seed):
    rng = np.random.default_rng(seed)
    return {n: (float(rng.uniform(0.2, 1.0)), float(rng.uniform(0.02, 0.2)))
            for n in ("conv2", "fc1", "fc3")}


@pytest.mark.parametrize("hw", list(HWS))
@pytest.mark.parametrize("budget", [BUDGET, 2e5, 64e6])
@pytest.mark.parametrize("realised", [False, True])
def test_run_dse_and_baseline_equal_reference(hw, budget, realised):
    jhw, thw = HWS[hw]
    dens = {"conv1": (0.8, 0.4), "fc1": (0.5, 0.125), "fc2": (0.5, 0.125)}
    js = jl.lenet_layer_specs(batch=4, densities=dens)
    ts = tl.lenet_layer_specs(batch=4, densities=dens)
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    if realised:
        js = jdse.apply_realised_densities(js, _realised(1))
        ts = tdse.apply_realised_densities(ts, _realised(1))
        assert [dataclasses.asdict(s) for s in ts] == \
            [dataclasses.asdict(s) for s in js]
    jb = jdse.balanced_folding_baseline(js, jhw, budget)
    tb = tdse.balanced_folding_baseline(ts, thw, budget)
    assert [dataclasses.asdict(c) for c in tb] == \
        [dataclasses.asdict(c) for c in jb]
    jr = jdse.run_dse(js, hw=jhw, resource_budget=budget)
    tr = tdse.run_dse(ts, hw=thw, resource_budget=budget)
    assert [dataclasses.asdict(c) for c in tr.configs] == \
        [dataclasses.asdict(c) for c in jr.configs]
    assert tr.trace == jr.trace
    assert tr.sparse_layers == jr.sparse_layers
    assert dataclasses.asdict(tr.estimate) == dataclasses.asdict(jr.estimate)
    assert dataclasses.asdict(tr.baseline) == dataclasses.asdict(jr.baseline)


@pytest.mark.parametrize("hw", list(HWS))
@pytest.mark.parametrize("bt", [1, 8, 512])
def test_choose_policy_equals_reference(hw, bt):
    jhw, thw = HWS[hw]
    for K, N, bits, (bd, ed), elig, mwe in itertools.product(
            (16, 256, 2048, 8192), (64, 2048), (2, 4, 8),
            ((1.0, 1.0), (0.25, 0.125), (0.05, 0.01)), (True, False),
            (0, 4096)):
        jr = jc.CompileRules(quant_bits=bits, batch_tokens=bt, hw=jhw,
                             min_weight_elems=mwe)
        tr = tc.CompileRules(quant_bits=bits, batch_tokens=bt, hw=thw,
                             min_weight_elems=mwe)
        kw = dict(block_density=bd, element_density=ed, sparse_eligible=elig)
        assert tc.choose_policy(K, N, rules=tr, **kw) == \
            jc.choose_policy(K, N, rules=jr, **kw), (K, N, bits, bd, elig)
    # conv leaves pass their own spec (MACs x output H*W)
    for js, ts in zip(jl.lenet_layer_specs(batch=bt),
                      tl.lenet_layer_specs(batch=bt)):
        for bits in (2, 4, 8):
            kw = dict(block_density=0.5, element_density=0.125,
                      sparse_eligible=True)
            assert tc.choose_policy(
                150, 16, rules=tc.CompileRules(quant_bits=bits, hw=thw,
                                               min_weight_elems=0),
                spec=ts, **kw) == jc.choose_policy(
                150, 16, rules=jc.CompileRules(quant_bits=bits, hw=jhw,
                                               min_weight_elems=0),
                spec=js, **kw)


# ------------------------------------------------------- compile passes


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


@pytest.fixture(scope="module")
def dense_models():
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


# no policies: the cost model picks per leaf (sparse where the rule block
# tiles the shape, its quant fallback where it cannot, dense below the
# weight floor)
AUTO_RULES = {
    "decode_int4": dict(block=(32, 32), min_weight_elems=0, quant_bits=4,
                        block_density=0.5, in_block_density=0.5),
    "prefill_int8": dict(block=(32, 32), min_weight_elems=0, quant_bits=8,
                         batch_tokens=512),
    "untileable_int2": dict(block=(48, 32), min_weight_elems=0,
                            quant_bits=2),
    "weight_floor": dict(block=(32, 32), min_weight_elems=8192,
                         quant_bits=4),
}


@pytest.mark.parametrize("name", list(AUTO_RULES))
def test_compile_model_without_policies_matches_reference(dense_models,
                                                          name):
    jcfg, tcfg, jp, tp = dense_models
    kw = AUTO_RULES[name]
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw))
    tcm = tc.compile_model(tp, tcfg, rules=tc.CompileRules(**kw),
                           device="cpu")
    rows = lambda cm: [(r.name, r.policy, r.shape, r.compressed_bytes,
                        r.container_bytes, r.block_density,
                        r.element_density) for r in cm.report]
    assert rows(tcm) == rows(jcm)
    jleaves, tleaves = dict(_leaves(jcm.params)), dict(_leaves(tcm.params))
    assert sorted(tleaves) == sorted(jleaves)
    for path, a in jleaves.items():
        a, b = _as_np(a), _as_np(tleaves[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    # the compiled decode step: one prefill chunk, then a decode step
    B = 2
    toks = np.random.default_rng(0).integers(0, 64, (B, 8)).astype(np.int32)
    jcache = jm.init_cache(jcfg, B, 16)
    tcache = tm.init_cache(tcfg, B, 16, device="cpu")
    jlog, jcache = jm.prefill_step(jcm.params, jcfg, jcache,
                                   jnp.asarray(toks), patterns=jcm.patterns,
                                   dispatch="jnp", t_bound=16, bt=8)
    tlog, tcache = tm.prefill_step(tcm.params, tcfg, tcache,
                                   torch.from_numpy(toks),
                                   patterns=tcm.patterns, t_bound=16, bt=8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = toks[:, :1]
    jlog, _ = jm.decode_step(jcm.params, jcfg, jcache, jnp.asarray(tok),
                             patterns=jcm.patterns, dispatch="jnp",
                             t_bound=16, bt=8)
    tlog, _ = tm.decode_step(tcm.params, tcfg, tcache, torch.from_numpy(tok),
                             patterns=tcm.patterns, t_bound=16, bt=8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.fixture(scope="module")
def lenet_params():
    jp = jl.init_lenet(jax.random.PRNGKey(0))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    for name, _, shape in tl.LAYERS:
        npp[name + "_b"] = (rng.normal(size=shape[-1]) / 10).astype(np.float32)
    return npp


@pytest.mark.parametrize("extra", [
    {}, {"batch_tokens": 256}, {"quant_bits": 2}, {"min_weight_elems": 512},
    {"block_density": 0.5, "in_block_density": 0.25}])
def test_compile_lenet_without_policies_matches_reference(lenet_params,
                                                          extra):
    """The Table-I whole-model rules (no policies), and variants."""
    kw = dict(WHOLE_MODEL_RULES, **extra)
    npp = lenet_params
    tp = interop.params_from_numpy(npp, "cpu")
    jcm = jc.compile_lenet(npp, rules=jc.CompileRules(**kw), blocks=BLOCKS)
    tcm = tc.compile_lenet(tp, rules=tc.CompileRules(**kw), blocks=BLOCKS,
                           device="cpu")
    rows = lambda cm: [(r.name, r.policy, r.shape, r.compressed_bytes,
                        r.container_bytes, r.block_density,
                        r.element_density, r.kind, r.m_scale)
                       for r in cm.report]
    assert rows(tcm) == rows(jcm)
    if not extra:  # the reference's own pick: sparse for all five layers
        assert [r.policy for r in tcm.report] == ["sparse"] * 5
    assert sorted(tcm.layers) == sorted(jcm.layers)
    assert tcm.fusion == jcm.fusion
    # every payload's leaves byte for byte, and the same patterns
    for name, jpl in jcm.layers.items():
        tpl = tcm.layers[name]
        jpl = getattr(jpl, "payload", jpl)
        tpl = getattr(tpl, "payload", tpl)
        jf, jleaves, jpat = jreg.unwrap_payload(jpl)
        tf, tleaves, tpat = treg.unwrap_payload(tpl)
        assert tf.name == jf.name, name
        assert sorted(tleaves) == sorted(jleaves), name
        for k, a in jleaves.items():
            np.testing.assert_array_equal(_as_np(tleaves[k]), _as_np(a),
                                          err_msg=f"{name} {k}")
    assert sorted(tcm.patterns) == sorted(jcm.patterns)
    for kn, pa in jcm.patterns.items():
        for f in ("bitmap", "block_rows", "block_cols"):
            np.testing.assert_array_equal(getattr(tcm.patterns[kn], f),
                                          getattr(pa, f))
    x = np.random.default_rng(3).normal(size=(4, 28, 28, 1)).astype(
        np.float32)
    want = jl.lenet_forward(npp, jnp.asarray(x), compressed=jcm.layers,
                            dispatch="jnp")
    got = tl.lenet_forward(tp, torch.from_numpy(x), compressed=tcm.layers,
                           fusion=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compile_conv_without_policy_matches_reference():
    w4 = np.random.default_rng(2).normal(size=(3, 3, 8, 32)).astype(
        np.float32)
    for bits in (2, 4, 8):
        kw = dict(block=(8, 4), min_weight_elems=0, quant_bits=bits)
        jcp, jpat, jrep = jc.compile_conv(w4, rules=jc.CompileRules(**kw),
                                          strides=(2, 2), in_hw=(16, 16))
        tcp, tpat, trep = tc.compile_conv(w4, rules=tc.CompileRules(**kw),
                                          strides=(2, 2), in_hw=(16, 16),
                                          device="cpu")
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        assert (tpat is None) == (jpat is None)
