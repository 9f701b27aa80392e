"""The encoder and VLM families of the port vs the JAX reference, at the
reference's ``reduced_config`` sizes in f32, with the reference's weights
carried across as numpy.

* hubert-like (``frontend="frame"``, non-causal, LayerNorm, GELU) and
  phi-3-vision-like (``frontend="patch"``, 4 prefix tokens): ``forward``
  raw and compiled (leaves and report rows byte-equal, ``frontend_proj``
  left dense and unreported), and ``loss_fn`` with labels; logits within
  ``1e-5 · max|logit|``;
* the VLM's ``prefill_step`` / ``decode_step`` with the float, int4 and
  int4x2 caches (codes exact), and ``ServeEngine``'s tokens equal to the
  reference engine's; an encoder has no decode cache in either package;
* ``patch_embed_apply`` and ``conv_apply`` on a raw leaf and on a compiled
  ``ConvPayload``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jlay  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serve.engine import Request as JReq, ServeEngine as JEng  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tlay  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serve.engine import Request as TReq, ServeEngine as TEng  # noqa: E402

REL = 1e-5        # of the largest logit (or cache value)
ARCHS = ["hubert-xlarge", "phi-3-vision-4.2b"]
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
CACHES = ["float", "int4", "int4x2"]


def _rules(cfg, policies):
    if policies is not None and cfg.act != "swiglu":
        policies = {k: v for k, v in policies.items() if k != "wg"}
    kw = dict(block=(16, 16), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, quant_bits=4, policies=policies)
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


def _rows(cm):
    return [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
             r.compressed_bytes, r.container_bytes, r.block_density,
             r.element_density) for r in cm.report]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    compiled = {}
    for name, pols in (("no_policies", None), ("serve", SERVE)):
        jr, tr = _rules(tcfg, pols)
        compiled[name] = (jc.compile_model(jp, jcfg, rules=jr),
                          tc.compile_model(tp, tcfg, rules=tr, device="cpu"))
    return arch, jcfg, tcfg, jp, tp, compiled


def _batch(cfg, B, T, seed):
    """The reference's and the port's batch: frame embeddings (encoder) or
    tokens, with prefix embeddings for the VLM; labels with masked
    positions."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "frame":
        b["frame_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        if cfg.frontend == "patch":
            b["prefix_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    b["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_reduced_configs_carry_the_features_under_test(model):
    arch, jcfg, tcfg, jp, tp, _ = model
    assert "frontend_proj" in tp
    if arch == "hubert-xlarge":
        assert (tcfg.family, tcfg.frontend, tcfg.causal) == \
            ("encoder", "frame", False)
        assert (tcfg.norm, tcfg.act) == ("ln", "gelu")
        assert not tcfg.supports_decode
    else:
        assert (tcfg.family, tcfg.frontend, tcfg.n_prefix_tokens) == \
            ("vlm", "patch", 4)
    assert tp["frontend_proj"]["w"].shape == (tcfg.d_model, tcfg.d_model)


@pytest.mark.parametrize("name", ["no_policies", "serve"])
def test_compile_leaves_and_report_equal_reference(model, name):
    arch, jcfg, tcfg, jp, tp, compiled = model
    jcm, tcm = compiled[name]
    _assert_trees_equal(tcm.params, jcm.params)
    assert _rows(tcm) == _rows(jcm)
    assert "frontend_proj" not in [r.name for r in tcm.report]
    assert tcm.params["frontend_proj"]["w"] is tp["frontend_proj"]["w"]
    assert sorted(tcm.patterns) == sorted(jcm.patterns)
    _assert_trees_equal(tc.decompress_model(tcm), jc.decompress_model(jcm))


@pytest.mark.parametrize("name", [None, "no_policies", "serve"])
def test_forward_and_loss_match_reference(model, name):
    arch, jcfg, tcfg, jp, tp, compiled = model
    (jparams, jpat), (tparams, tpat) = ((jp, None), (tp, None)) \
        if name is None else ((compiled[name][0].params,
                               compiled[name][0].patterns),
                              (compiled[name][1].params,
                               compiled[name][1].patterns))
    jbatch, tbatch = _batch(tcfg, 2, 12, 0)
    jl = jm.forward(jparams, jcfg, jbatch, patterns=jpat, dispatch="jnp")
    with torch.no_grad():
        tl = tm.forward(tparams, tcfg, tbatch, patterns=tpat)
    P = tcfg.n_prefix_tokens if tcfg.frontend == "patch" else 0
    assert tuple(tl.shape) == (2, 12 + P, tcfg.vocab)
    _close(tl, jl)
    if name is None:
        jloss = float(jm.loss_fn(jp, jcfg, jbatch))
        with torch.no_grad():
            tloss = float(tm.loss_fn(tp, tcfg, tbatch))
        assert abs(tloss - jloss) <= REL * abs(jloss)


def test_encoder_is_bidirectional_and_has_no_decode_cache():
    jcfg, tcfg = j_reduced("hubert-xlarge"), t_reduced("hubert-xlarge")
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    _, tbatch = _batch(tcfg, 1, 8, 3)
    with torch.no_grad():
        a = tm.forward(tp, tcfg, tbatch)
        later = dict(tbatch, frame_embeds=tbatch["frame_embeds"].clone())
        later["frame_embeds"][0, -1] += 1.0
        b = tm.forward(tp, tcfg, later)
    # the last frame reaches the first position: no causal mask
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 0
    for fn in (lambda c: jm.init_cache(c, 1, 8), lambda c: jm.cache_batch_axes(c)):
        with pytest.raises(ValueError, match="encoder has no decode cache"):
            fn(jcfg)
    with pytest.raises(ValueError, match="encoder has no decode cache"):
        tm.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder has no decode cache"):
        tm.cache_batch_axes(tcfg)
    with pytest.raises(ValueError, match="encoder has no decode cache"):
        tm.decode_step(tp, tcfg, {}, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder has no decode cache"):
        TEng(tp, tcfg, device="cpu")


def _check_caches(jcache, tcache):
    assert sorted(jcache) == sorted(tcache)
    for k, jv in jcache.items():
        jv, tv = np.asarray(jv), tcache[k].numpy()
        if jv.dtype.kind == "f":
            _close(tcache[k], jv)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)


@pytest.mark.parametrize("kv", CACHES)
@pytest.mark.parametrize("name", [None, "serve"])
def test_vlm_prefill_and_decode_steps_match_reference(kv, name):
    arch = "phi-3-vision-4.2b"
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    jpat = tpat = None
    if name is not None:
        jr, tr = _rules(tcfg, SERVE)
        jcm = jc.compile_model(jp, jcfg, rules=jr)
        tcm = tc.compile_model(tp, tcfg, rules=tr, device="cpu")
        jp, jpat, tp, tpat = jcm.params, jcm.patterns, tcm.params, \
            tcm.patterns
    B, T = 3, 16
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    assert tm.cache_batch_axes(tcfg, kv) == jm.cache_batch_axes(jcfg, kv)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, size=(B, 8)).astype(np.int32)
    nv = np.array([8, 5, 0], np.int32)
    jl, jcache = jm.prefill_step(jp, jcfg, jcache, jnp.asarray(toks),
                                 patterns=jpat, dispatch="jnp",
                                 n_valid=jnp.asarray(nv), t_bound=16, bt=8)
    tl, tcache = tm.prefill_step(tp, tcfg, tcache, torch.from_numpy(toks),
                                 patterns=tpat, n_valid=torch.from_numpy(nv),
                                 t_bound=16, bt=8)
    for b in range(B):
        if nv[b]:
            _close(tl[b, :nv[b]], np.asarray(jl)[b, :nv[b]])
    _check_caches(jcache, tcache)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jcfg, jcache, jnp.asarray(tok),
                                    patterns=jpat, dispatch="jnp",
                                    t_bound=16, bt=8)
        tl, tcache = tm.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                                    patterns=tpat, t_bound=16, bt=8)
        _close(tl, jl)
        _check_caches(jcache, tcache)


@pytest.mark.parametrize("kv", ["float", "int4x2"])
def test_vlm_serve_engine_tokens_match_reference(kv):
    arch = "phi-3-vision-4.2b"
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    jr, tr = _rules(tcfg, SERVE)
    jcm = jc.compile_model(jp, jcfg, rules=jr)
    tcm = tc.compile_model(tp, tcfg, rules=tr, device="cpu")
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
    assert eng._chunked and eng.stats()["prefill_steps"] > 0


def _conv_case():
    rng = np.random.default_rng(17)
    kh = kw = 4
    cin, cout = 3, 8
    w4 = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return w4, x, b


@pytest.mark.parametrize("policy", [None, "sparse", "quant"])
def test_patch_embed_apply_matches_reference(policy):
    """The raw leaf (a strided VALID conv) and a ConvPayload compiled at
    the patch geometry, through both packages' hook; the explicit bias
    overrides the leaf's own; a stride-1 payload raises."""
    w4, x, b = _conv_case()
    kh, kw = w4.shape[:2]
    if policy is None:
        jp_ = {"w": jnp.asarray(w4), "b": jnp.asarray(b)}
        tp_ = {"w": torch.from_numpy(w4), "b": torch.from_numpy(b)}
        kwj, kwt = {}, {}
    else:
        rules = dict(block=(8, 4), min_weight_elems=0, quant_bits=8,
                     block_density=0.5)
        jp_ = jc.compile_conv(w4, policy=policy, strides=(kh, kw),
                              rules=jc.CompileRules(**rules))[0]
        tp_ = tc.compile_conv(w4, policy=policy, strides=(kh, kw),
                              rules=tc.CompileRules(**rules),
                              device="cpu")[0]
        assert isinstance(tp_, td.ConvPayload)
        kwj, kwt = {"bias": jnp.asarray(b)}, {"bias": torch.from_numpy(b)}
    jy = jb.patch_embed_apply(jp_, jnp.asarray(x), activation="relu",
                              dispatch="jnp", **kwj)
    ty = tb.patch_embed_apply(tp_, torch.from_numpy(x), activation="relu",
                              **kwt)
    assert tuple(ty.shape) == (2, 2, 2, 8)
    _close(ty, jy)
    if policy is None:
        ty2 = tb.patch_embed_apply({"w": torch.from_numpy(w4)},
                                   torch.from_numpy(x),
                                   bias=torch.from_numpy(b),
                                   activation="relu")
        _close(ty2, jy)
    else:
        bad = td.ConvPayload(payload=tp_.payload, kernel=tp_.kernel)
        with pytest.raises(ValueError, match="strides"):
            tb.patch_embed_apply(bad, torch.from_numpy(x))


@pytest.mark.parametrize("policy", ["sparse", "quant"])
def test_conv_apply_matches_reference(policy):
    """``conv_apply`` is ``conv_dispatch`` in both packages: a stride-1
    compiled conv with bias and activation."""
    w4, x, b = _conv_case()
    rules = dict(block=(8, 4), min_weight_elems=0, quant_bits=8,
                 block_density=0.5)
    jcp = jc.compile_conv(w4, policy=policy,
                          rules=jc.CompileRules(**rules))[0]
    tcp = tc.compile_conv(w4, policy=policy, rules=tc.CompileRules(**rules),
                          device="cpu")[0]
    jy = jlay.conv_apply(jcp, jnp.asarray(x), bias=jnp.asarray(b),
                         activation="gelu", dispatch="jnp")
    ty = tlay.conv_apply(tcp, torch.from_numpy(x), bias=torch.from_numpy(b),
                         activation="gelu")
    assert tuple(ty.shape) == (2, 5, 5, 8)
    _close(ty, jy)


# the untied heads of the new configs at full width: hubert-xlarge and
# phi-3-vision-4.2b (vocabularies the 128-block does not tile),
# olmoe-1b-7b and qwen2-moe-a2.7b
HEADS = [(1280, 504), (3072, 32064), (2048, 50304), (2048, 151936)]


@pytest.mark.parametrize("K,N", HEADS)
def test_head_block_fit_and_policy_pick_equal_reference(K, N):
    """The full-width heads' rule-block fit and the cost model's pick
    under the serving rules (no policy for the head) equal the
    reference's; a vocabulary the block cannot tile is never sparse."""
    kw = dict(block=(128, 128), block_density=0.25, in_block_density=0.5,
              min_weight_elems=0, quant_bits=4)
    jr, tr = jc.CompileRules(**kw), tc.CompileRules(**kw)
    jb_, tb_ = jc._fit_block(K, N, jr.block), tc._fit_block(K, N, tr.block)
    assert tb_ == jb_
    picks = [m._decide_policy("head", None, K, N, r, block=blk,
                              block_density=0.25, element_density=0.125)
             for m, r, blk in ((jc, jr, jb_), (tc, tr, tb_))]
    assert picks[1] == picks[0]
    if N % 128:
        assert tb_ is None and picks[1][0] in ("quant", "dense")
