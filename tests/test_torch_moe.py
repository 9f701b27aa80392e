"""The MoE family of the port vs the JAX reference, at the reference's
``reduced_config`` sizes in f32 (olmoe-1b-7b: 8 experts, top-4, no shared
expert; qwen2-moe-a2.7b: the same with one shared expert), with the
reference's weights carried across as numpy.

* the routing of ``moe_apply`` with drops (S = 32, E = 8, K = 4, C = 20 <
  S): expert ids and the keep mask exactly the reference's, ties to the
  lower expert as ``jax.lax.top_k``; outputs within ``1e-5 · max|y|``;
* ``compile_model``: leaves, patterns and report rows byte-equal, the
  routed experts and the router dense rows, the shared expert compiled;
* ``forward`` / ``loss_fn`` over B·T tokens (the drop path), and
  ``decode_step`` with the float, int4 and int4x2 caches, logits within
  ``1e-5 · max|logit|``; ``active`` and ``prefill_step`` refused;
* the token drip ``ServeEngine``: tokens equal to the reference engine's,
  and an idle slot stepped past ``max_len`` with every attention read held
  to its extent.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serve.engine import Request as JReq, ServeEngine as JEng  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

REL = 1e-5
ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
CACHES = ["float", "int4", "int4x2"]


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


def _rules(policies, cfg=None):
    """The compile rules in both packages; a policy key that names no leaf
    raises, so the MLP keys go where the config has no shared expert."""
    if policies is not None and not cfg.n_shared_experts:
        policies = {k: v for k, v in policies.items()
                    if k not in ("wg", "wu", "wd")}
    kw = dict(block=(16, 16), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, quant_bits=4, policies=policies)
    return jc.CompileRules(**kw), tc.CompileRules(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    jr, tr = _rules(SERVE, tcfg)
    compiled = (jc.compile_model(jp, jcfg, rules=jr),
                tc.compile_model(tp, tcfg, rules=tr, device="cpu"))
    return arch, jcfg, tcfg, jp, tp, compiled


def _reference_routing(p, cfg, xt):
    """The reference ``_moe_apply``'s routing lines (ids, keep, dest)."""
    S = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.astype(jnp.float32) @ p["router"]["w"]
    gates = jax.nn.softmax(logits, axis=-1)
    _, ids_k = jax.lax.top_k(gates, K)
    C = max(8, min(int(np.ceil(S * K / E * cfg.capacity_factor)), S))
    flat_ids = ids_k.reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    seg_start = jnp.searchsorted(sorted_ids, jnp.arange(E))
    rank = jnp.arange(S * K) - seg_start[sorted_ids]
    keep = rank < C
    dest = jnp.where(keep, sorted_ids * C + rank, E * C)
    return (np.asarray(ids_k), np.asarray(order), np.asarray(keep),
            np.asarray(dest), C)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def test_reduced_configs_carry_the_features_under_test(model):
    arch, jcfg, tcfg, jp, tp, _ = model
    assert (tcfg.family, tcfg.n_experts, tcfg.top_k, tcfg.d_expert) == \
        ("moe", 8, 4, 32)
    moe = tp["blocks"]["moe"]
    assert tuple(moe["eg"]["w"].shape) == (2, 8, 64, 32)
    assert moe["router"]["w"].dtype == torch.float32
    assert ("shared" in moe) == (arch == "qwen2-moe-a2.7b")
    assert "mlp" not in tp["blocks"]


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_moe_routing_and_output_match_reference_with_drops(model, scale):
    """32 tokens, 8 experts, top-4: capacity 20 < 32, so skewed routing
    drops entries.  ``scale=0`` zeroes the router: every gate ties and
    the lower expert ids win, as ``jax.lax.top_k`` orders them."""
    arch, jcfg, tcfg, jp, tp, _ = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    jp0 = _layer0(jp["blocks"]["moe"])
    jp0 = dict(jp0, router={"w": jp0["router"]["w"] * scale})
    # a shifted input skews the router toward a few experts
    x = x + 2.0 * np.asarray(jp0["router"]["w"])[:, 0][None, None] * scale
    tp0 = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp0),
                                    "cpu")
    xt = x.reshape(32, -1)
    ids, order, keep, dest, C = _reference_routing(jp0, jcfg, jnp.asarray(xt))
    assert C == tb.moe_capacity(tcfg, 32) == 20
    t_ids, _, t_order, t_keep, t_dest = tb.moe_route(tp0, tcfg,
                                                     torch.from_numpy(xt))
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_dest.numpy(), dest)
    assert not keep.all(), "the case must drop entries"
    if scale == 0.0:
        assert (ids == np.arange(4)[None]).all()
    jy = jb.moe_apply(jp0, jcfg, jnp.asarray(x))
    ty = tb.moe_apply(tp0, tcfg, torch.from_numpy(x))
    _close(ty, jy)


def test_compile_leaves_and_report_equal_reference(model):
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    _assert_trees_equal(tcm.params, jcm.params)
    rows = lambda cm: [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
                        r.compressed_bytes, r.container_bytes,
                        r.block_density, r.element_density)
                       for r in cm.report]
    assert rows(tcm) == rows(jcm)
    policy = {r.name: r.policy for r in tcm.report}
    for k in ("router", "eg", "eu", "ed"):
        assert policy[f"blocks/moe/{k}"] == "dense"
        assert tcm.params["blocks"]["moe"][k]["w"] is \
            tp["blocks"]["moe"][k]["w"]
    if arch == "qwen2-moe-a2.7b":
        assert policy["blocks/moe/shared/wg"] == "sparse"
        assert "w_blkp" in tcm.params["blocks"]["moe"]["shared"]["wg"]
    assert sorted(tcm.patterns) == sorted(jcm.patterns)
    for kn, pat in jcm.patterns.items():
        np.testing.assert_array_equal(tcm.patterns[kn].bitmap,
                                      np.asarray(pat.bitmap))
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    _assert_trees_equal(tc.decompress_model(tcm), jc.decompress_model(jcm))
    # with no policies: the cost model's pick on every lowered leaf
    jr, tr = _rules(None)
    assert rows(tc.compile_model(tp, tcfg, rules=tr, device="cpu")) == \
        rows(jc.compile_model(jp, jcfg, rules=jr))


@pytest.mark.parametrize("compiled", [False, True])
def test_forward_and_loss_match_reference(model, compiled):
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    jparams, jpat, tparams, tpat = (jcm.params, jcm.patterns, tcm.params,
                                    tcm.patterns) if compiled \
        else (jp, None, tp, None)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :4] = -1
    jl = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                    patterns=jpat, dispatch="jnp")
    with torch.no_grad():
        tl = tm.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        patterns=tpat)
    _close(tl, jl)
    if not compiled:
        jloss = float(jm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)}))
        with torch.no_grad():
            tloss = float(tm.loss_fn(tp, tcfg, {
                "tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)}))
        assert abs(tloss - jloss) <= REL * abs(jloss)


def _check_caches(jcache, tcache):
    assert sorted(jcache) == sorted(tcache)
    for k, jv in jcache.items():
        jv, tv = np.asarray(jv), tcache[k].numpy()
        if jv.dtype.kind == "f":
            _close(tcache[k], jv)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)


@pytest.mark.parametrize("kv", CACHES)
def test_decode_steps_match_reference(model, kv):
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    B, T = 3, 16
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    assert tm.cache_batch_axes(tcfg, kv) == jm.cache_batch_axes(jcfg, kv)
    rng = np.random.default_rng(1)
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jcm.params, jcfg, jcache,
                                    jnp.asarray(tok), patterns=jcm.patterns,
                                    dispatch="jnp", t_bound=16, bt=8)
        tl, tcache = tm.decode_step(tcm.params, tcfg, tcache,
                                    torch.from_numpy(tok),
                                    patterns=tcm.patterns, t_bound=16, bt=8)
        _close(tl, jl)
        _check_caches(jcache, tcache)


def test_moe_refuses_active_mask_and_chunked_prefill(model):
    arch, jcfg, tcfg, jp, tp, _ = model
    cache = tm.init_cache(tcfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported for moe"):
        tm.decode_step(tp, tcfg, cache, tok, active=torch.ones(2))
    with pytest.raises(ValueError, match="attention-only families"):
        tm.prefill_step(tp, tcfg, cache, torch.zeros((2, 4),
                                                     dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported for moe"):
        jm.decode_step(jp, jcfg, jm.init_cache(jcfg, 2, 8), jnp.asarray(tok),
                       active=jnp.ones(2))


def _serve(eng, req, prompts, new):
    for i, p in enumerate(prompts):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=new[i]))
    return [r.out for r in sorted(eng.run(), key=lambda r: r.uid)]


@pytest.mark.parametrize("kv", ["float", "int4x2"])
def test_drip_engine_tokens_match_reference(model, kv):
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 19, 33, 12, 1)]
    new = [6, 6, 6, 6, 0]
    kw = dict(batch_slots=3, max_len=64, kv_cache=kv)
    jout = _serve(JEng(jcm, jcfg, dispatch="jnp", **kw), JReq, prompts, new)
    eng = teng.ServeEngine(tcm, tcfg, device="cpu", **kw)
    tout = _serve(eng, teng.Request, prompts, new)
    assert tout == jout
    assert [len(o) for o in tout] == new
    st = eng.stats()
    assert not eng._chunked and st["prefill_steps"] == 0
    assert st["decode_tokens"] == eng.tokens_processed() > 0
    assert st["decode_steps"] == len(st["decode_ms"])
    assert eng.stats()["graphs"] == 0     # the CPU runs eagerly


def test_drip_idle_slot_past_max_len_reads_within_its_extent(model,
                                                              monkeypatch):
    """Two slots, max_len 16: B (slot 1) finishes first and A2 takes its
    slot, up to max_len, while slot 0 sits idle once A1 is done and keeps
    stepping, its length past max_len.  The tokens equal the reference
    engine's, and no attention read is handed a live length past the rows
    it was given."""
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (4, 3, 6)]
    new = [4, 2, 11]
    kw = dict(batch_slots=2, max_len=16, kv_cache="int4x2")
    jout = _serve(JEng(jcm, jcfg, dispatch="jnp", **kw), JReq, prompts, new)
    seen = []
    real = tb.attn_packed_dispatch

    def spy(q, k_c, v_c, k_s, v_s, lengths, **kw_):
        seen.append((int(lengths.max()), int(k_c.shape[1])))
        return real(q, k_c, v_c, k_s, v_s, lengths, **kw_)

    monkeypatch.setattr(tb, "attn_packed_dispatch", spy)
    eng = teng.ServeEngine(tcm, tcfg, device="cpu", **kw)
    tout = _serve(eng, teng.Request, prompts, new)
    assert tout == jout and [len(o) for o in tout] == new
    assert int(eng.cache["length"][0].max()) > kw["max_len"]
    assert seen and all(n <= rows for n, rows in seen)
    assert {rows for _, rows in seen} >= {16}


def test_drip_idle_slot_past_its_bucket_reads_within_the_bucket(model,
                                                                monkeypatch):
    """An idle slot whose length runs past the bucket the active slots
    need: the read of that bucket clamps the idle slot's live rows to it."""
    arch, jcfg, tcfg, jp, tp, (jcm, tcm) = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (10, 3, 2)]
    new = [4, 12, 25]
    kw = dict(batch_slots=2, max_len=64, kv_cache="int4")
    jout = _serve(JEng(jcm, jcfg, dispatch="jnp", **kw), JReq, prompts, new)
    seen = []
    real = tb.attn_packed_dispatch

    def spy(q, k_c, v_c, k_s, v_s, lengths, **kw_):
        seen.append((lengths[:, 0].tolist(), int(k_c.shape[1])))
        return real(q, k_c, v_c, k_s, v_s, lengths, **kw_)

    monkeypatch.setattr(tb, "attn_packed_dispatch", spy)
    eng = teng.ServeEngine(tcm, tcfg, device="cpu", **kw)
    assert _serve(eng, teng.Request, prompts, new) == jout
    # request 0 frees slot 0 after 13 steps and request 2 takes it (26
    # positions: bucket 32 throughout); slot 1 idles after request 1's 14
    # steps and keeps stepping, past 32 positions
    assert int(eng.cache["length"][0, 1]) > 32
    assert all(max(lens) <= rows for lens, rows in seen)
    assert {rows for _, rows in seen} == {32}
    assert any(lens[1] == 32 for lens, _ in seen)


def test_mlp_width_override_and_leaf_names():
    cfg = dataclasses.replace(t_reduced("qwen2-moe-a2.7b"))
    gen = torch.Generator().manual_seed(0)
    p = tb.mlp_init(gen, cfg, 2, d_ff=48)
    assert tuple(p["wg"]["w"].shape) == (2, 64, 48)
    assert tuple(p["wd"]["w"].shape) == (2, 48, 64)
    x = torch.randn(3, 64)
    y = tb.mlp_apply({k: {"w": v["w"][0]} for k, v in p.items()}, cfg, x,
                     d_ff=48, name="moe/shared")
    assert tuple(y.shape) == (3, 64)
    tp = tm.init_params(cfg, seed=0, device="cpu")
    moe = tp["blocks"]["moe"]
    assert tuple(moe["shared"]["wg"]["w"].shape) == (2, 64, 32)
    assert tuple(moe["ed"]["w"].shape) == (2, 8, 32, 64)
    assert tuple(moe["router"]["w"].shape) == (2, 64, 8)
