"""The cases of ``tests/test_torch_dense_zoo_*.py``: one of the port's
other dense configs vs the JAX reference, at reduced size — qwen1.5-4b
(MHA, QKV bias, untied head, rope theta 1e6) or starcoder2-7b (LayerNorm,
tanh GELU MLP with no ``wg``, GQA, QKV bias, untied head) — with the
reference's weights carried across as numpy.  Each test file names its
config as ``ARCH`` and imports these cases (one file a config, so
pytest-xdist's workers run them side by side).

* compiled with no policies (the cost model's pick, the untied head
  included), with the serving rules and with the family map: leaves, report
  rows and the dense oracle equal the reference's byte for byte;
* ``forward``, ``prefill_step`` and three ``decode_step`` calls with the
  float, int4 and int4x2 caches: logits within ``1e-5 · max|logit|`` (the
  two packages sum in different orders), cache codes exact, the float
  cache's rows and the scales within ``1e-5`` of the leaf's largest value;
* ``ServeEngine`` serves the same tokens as the reference's engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serve.engine import Request as JReq, ServeEngine as JEng  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serve.engine import Request as TReq, ServeEngine as TEng  # noqa: E402

REL = 1e-5        # of the largest logit (or cache value)
TAU = 0.05
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
FAMILY_MAP = {"wq": "perchannel", "wo": "perchannel", "wk": "bfp8",
              "wv": "bfp8", "wg": "actsparse", "wu": "actsparse",
              "wd": "actsparse"}
# compile -> (rules, policies); the GELU MLP has no "wg", and a policy key
# naming no leaf raises, so it is dropped where the config has none
COMPILES = {
    "no_policies": (dict(quant_bits=4), None),
    "serve": (dict(quant_bits=4), SERVE),
    "family_map": (dict(quant_bits=8, act_threshold=TAU), FAMILY_MAP),
}
CACHES = ["float", "int4", "int4x2"]


def _rules(cfg, name):
    kw, pols = COMPILES[name]
    if pols is not None and cfg.act != "swiglu":
        pols = {k: v for k, v in pols.items() if k != "wg"}
    kw = dict(block=(16, 16), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, policies=pols, **kw)
    return jc.CompileRules(**kw), tc.CompileRules(**kw)


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


def _assert_trees_equal(ttree, jtree):
    jl_, tl_ = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(tl_) == sorted(jl_)
    for path, a in jl_.items():
        a, b = _as_np(a), _as_np(tl_[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


def _close(t, j):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= REL * float(np.abs(j).max())


@pytest.fixture(scope="module")
def model(request):
    arch = request.module.ARCH
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    compiled = {}
    for name in COMPILES:
        jr, tr = _rules(tcfg, name)
        compiled[name] = (jc.compile_model(jp, jcfg, rules=jr),
                          tc.compile_model(tp, tcfg, rules=tr, device="cpu"))
    return arch, jcfg, tcfg, jp, tp, compiled


def test_reduced_configs_carry_the_features_under_test(model):
    arch, jcfg, tcfg, jp, tp, _ = model
    assert tcfg.qkv_bias and not tcfg.tie_embeddings and "head" in tp
    assert "b" in tp["blocks"]["attn"]["wq"]
    if arch == "qwen1.5-4b":
        assert tcfg.n_kv_heads == tcfg.n_heads and tcfg.rope_theta == 1e6
    else:
        assert (tcfg.norm, tcfg.act) == ("ln", "gelu")
        assert tcfg.n_kv_heads < tcfg.n_heads
        assert "wg" not in tp["blocks"]["mlp"] and "b" in tp["blocks"]["ln1"]


@pytest.mark.parametrize("name", list(COMPILES))
def test_compile_leaves_and_report_equal_reference(model, name):
    arch, jcfg, tcfg, jp, tp, compiled = model
    jcm, tcm = compiled[name]
    _assert_trees_equal(tcm.params, jcm.params)
    rows = lambda cm: [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
                        r.compressed_bytes, r.container_bytes,
                        r.block_density, r.element_density)
                       for r in cm.report]
    assert rows(tcm) == rows(jcm)
    assert "head" in [r.name for r in tcm.report]
    assert sorted(tcm.patterns) == sorted(jcm.patterns)
    for kn, pat in jcm.patterns.items():
        np.testing.assert_array_equal(tcm.patterns[kn].bitmap,
                                      np.asarray(pat.bitmap))
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    _assert_trees_equal(tc.decompress_model(tcm), jc.decompress_model(jcm))


@pytest.mark.parametrize("name", [None] + list(COMPILES))
def test_forward_matches_reference(model, name):
    arch, jcfg, tcfg, jp, tp, compiled = model
    (jparams, jpat), (tparams, tpat) = ((jp, None), (tp, None)) \
        if name is None else ((compiled[name][0].params,
                               compiled[name][0].patterns),
                              (compiled[name][1].params,
                               compiled[name][1].patterns))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12))
    jl = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                    patterns=jpat, dispatch="jnp")
    with torch.no_grad():
        tl = tm.forward(tparams, tcfg, {"tokens": torch.as_tensor(
            toks, dtype=torch.int32)}, patterns=tpat)
    _close(tl, jl)


def _check_caches(jcache, tcache):
    assert sorted(jcache) == sorted(tcache)
    for k, jv in jcache.items():
        jv, tv = np.asarray(jv), tcache[k].numpy()
        if jv.dtype.kind == "f":
            _close(tcache[k], jv)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)


@pytest.mark.parametrize("kv", CACHES)
@pytest.mark.parametrize("name", [None] + list(COMPILES))
def test_prefill_and_decode_steps_match_reference(model, name, kv):
    arch, jcfg, tcfg, jp, tp, compiled = model
    (jparams, jpat), (tparams, tpat) = ((jp, None), (tp, None)) \
        if name is None else ((compiled[name][0].params,
                               compiled[name][0].patterns),
                              (compiled[name][1].params,
                               compiled[name][1].patterns))
    B, T = 3, 16
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, size=(B, 8)).astype(np.int32)
    nv = np.array([8, 5, 0], np.int32)
    jl, jcache = jm.prefill_step(jparams, jcfg, jcache, jnp.asarray(toks),
                                 patterns=jpat, dispatch="jnp",
                                 n_valid=jnp.asarray(nv), t_bound=16, bt=8)
    tl, tcache = tm.prefill_step(tparams, tcfg, tcache,
                                 torch.from_numpy(toks), patterns=tpat,
                                 n_valid=torch.from_numpy(nv), t_bound=16,
                                 bt=8)
    for b in range(B):
        if nv[b]:
            _close(tl[b, :nv[b]], np.asarray(jl)[b, :nv[b]])
    _check_caches(jcache, tcache)
    for step in range(3):
        tok = rng.integers(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                    patterns=jpat, dispatch="jnp",
                                    t_bound=16, bt=8)
        tl, tcache = tm.decode_step(tparams, tcfg, tcache,
                                    torch.from_numpy(tok), patterns=tpat,
                                    t_bound=16, bt=8)
        _close(tl, jl)
        _check_caches(jcache, tcache)


@pytest.mark.parametrize("kv", ["float", "int4x2"])
def test_serve_engine_tokens_match_reference(model, kv):
    arch, jcfg, tcfg, jp, tp, compiled = model
    jcm, tcm = compiled["serve"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 19, 33, 12)]
    kw = dict(batch_slots=2, max_len=64, prefill_chunk=8, kv_cache=kv)
    outs = []
    for eng in (JEng(jcm, jcfg, dispatch="jnp", **kw),
                TEng(tcm, tcfg, device="cpu", **kw)):
        req = JReq if isinstance(eng, JEng) else TReq
        for i, p in enumerate(prompts):
            eng.submit(req(uid=i, prompt=p, max_new_tokens=6))
        outs.append([r.out for r in sorted(eng.run(), key=lambda r: r.uid)])
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[1])
