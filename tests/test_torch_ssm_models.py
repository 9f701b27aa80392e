"""The SSM (xlstm-1.3b) and hybrid (zamba2-2.7b) families of the port vs
the JAX reference, at the reference's ``reduced_config`` sizes in f32
(xLSTM: 1 super-block of 1 sLSTM + 7 mLSTM; Zamba2: 2 super-blocks of the
shared attention + 2 Mamba2), with the reference's weights carried across
as numpy, under ``linear_mode`` "dense" and "int8".

* the parameter tree's layout; ``forward`` and ``loss_fn`` (T = 7, and 300:
  two chunks and a ragged tail) and ``decode_step`` with its nested cache,
  logits within ``REL · max|logit|``; ``init_cache`` / ``cache_batch_axes``
  mirror the reference; the chunkwise forward equals the recurrence on
  the port (the reference's ``test_prefill_decode_consistency``);
* ``compile_model`` on the hybrid: only the shared attention and the head
  lowered, leaves, patterns and report rows byte-equal, the aggregate
  ``"blocks (ssm, not lowered)"`` row, the ``decompress_model`` round trip;
  the SSM family refused with the reference's message;
* ``ServeEngine``'s token drip on both families: tokens equal to the
  reference engine's; churn with ``attn_every == batch_slots`` against a
  fresh engine; ``prefill_chunk`` ignored.
"""
import dataclasses

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
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

REL = 1e-5
# T = 300 through xlstm's 7 mLSTM layers: each chunkwise block sums its
# 256-term chunk products in another order than XLA (~7e-6 of its largest
# output, tests/test_torch_ssm.py), and the layers compound it
LONG_REL = {"xlstm-1.3b": 1e-4, "zamba2-2.7b": REL}
ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
MODES = ["dense", "int8"]
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 \
            else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


def _items(tree):
    return dict(tree_items(tree))


def _assert_trees_equal(ttree, jtree):
    jl_, tl_ = _items(jtree), _items(ttree)
    assert sorted(tl_) == sorted(jl_)
    for path, a in jl_.items():
        a, b = _as_np(a), _as_np(tl_[path])
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


def _close(t, j, rel=REL):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    err = float(np.abs(t - j).max())
    assert err <= rel * max(float(np.abs(j).max()), 1e-30), err


def _cfgs(arch, mode):
    return (dataclasses.replace(j_reduced(arch), linear_mode=mode),
            dataclasses.replace(t_reduced(arch), linear_mode=mode))


_MODELS = {}


def _model(arch, mode="dense"):
    """(reference cfg, port cfg, reference params, port params), cached."""
    key = (arch, mode)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, mode)
        jp = _np(jm.init_params(jax.random.PRNGKey(0), jcfg))
        _MODELS[key] = (jcfg, tcfg, jp, interop.params_from_numpy(jp, "cpu"))
    return _MODELS[key]


def _rules(policies=SERVE):
    kw = dict(block=(16, 16), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, quant_bits=4, policies=policies)
    return jc.CompileRules(**kw), tc.CompileRules(**kw)


@pytest.fixture(scope="module")
def hybrid_compiled():
    jcfg, tcfg, jp, tp = _model("zamba2-2.7b")
    jr, tr = _rules()
    return (jc.compile_model(jp, jcfg, rules=jr),
            tc.compile_model(tp, tcfg, rules=tr, device="cpu"))


def _sig(tree):
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in _items(tree).items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_layout_matches_reference(arch, mode):
    """The port's own init draws the reference's tree: the super-block
    stacks (L, n_inner, ...), the SSM projections int8 under "int8", the
    hybrid's unstacked shared attention."""
    jcfg, tcfg, jp, _ = _model(arch, mode)
    ours = tm.init_params(tcfg, seed=0, device="cpu")
    assert _sig(ours) == _sig(jp)
    if arch == "xlstm-1.3b":
        wq = ours["blocks"]["mlstm"]["wq"]
        assert set(wq) == ({"w_q", "w_s"} if mode == "int8" else {"w"})
        assert tuple(ours["blocks"]["m_ln"]["g"].shape) == (1, 7, 64)
    else:
        assert tuple(ours["shared_attn"]["attn"]["wq"][
            "w_q" if mode == "int8" else "w"].shape) == (64, 64)
        assert tuple(ours["blocks"]["mamba"]["conv"].shape) == (2, 2, 4, 160)


@pytest.mark.parametrize("T", [7, 300])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, mode, T):
    jcfg, tcfg, jp, tp = _model(arch, mode)
    rng = np.random.default_rng(T)
    toks = rng.integers(0, tcfg.vocab, (2, T)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (2, T)).astype(np.int32)
    labels[0, :3] = -1
    rel = REL if T < 256 else LONG_REL[arch]
    jl = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, dispatch="jnp")
    with torch.no_grad():
        tl = tm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert bool(torch.isfinite(tl).all())
    _close(tl, jl, rel)
    if T < 256:
        jloss = float(jm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)}))
        with torch.no_grad():
            tloss = float(tm.loss_fn(tp, tcfg, {
                "tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)}))
        assert abs(tloss - jloss) <= REL * abs(jloss)


def _check_caches(jcache, tcache):
    jl_, tl_ = _items(jcache), _items(tcache)
    assert sorted(jl_) == sorted(tl_)
    for path, jv in jl_.items():
        jv = np.asarray(jv)
        if jv.dtype.kind == "f":
            _close(tl_[path], jv)
        else:
            np.testing.assert_array_equal(tl_[path].numpy(), jv,
                                          err_msg=str(path))


DECODE = [("xlstm-1.3b", "dense", "float"), ("xlstm-1.3b", "int8", "float"),
          ("zamba2-2.7b", "dense", "float"), ("zamba2-2.7b", "int8", "int4"),
          ("zamba2-2.7b", "dense", "int4x2")]


@pytest.mark.parametrize("arch,mode,kv", DECODE)
def test_decode_steps_and_cache_match_reference(arch, mode, kv):
    """5 decode steps from a zero cache: logits and every nested cache leaf
    (recurrent states within REL, KV codes and lengths exact); the cache
    is updated in place."""
    jcfg, tcfg, jp, tp = _model(arch, mode)
    B, T = 3, 16
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    assert _sig(tcache) == _sig(_np(jcache))
    assert tm.cache_batch_axes(tcfg, kv) == jm.cache_batch_axes(jcfg, kv)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t,
                                                  dispatch="jnp"))
    leaves = _items(tcache)
    rng = np.random.default_rng(1)
    for _ in range(5):
        tok = rng.integers(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok))
        with torch.no_grad():
            tl, out = tm.decode_step(tp, tcfg, tcache, torch.from_numpy(tok))
        assert out is tcache
        _close(tl, jl)
        _check_caches(jcache, tcache)
    assert all(v is leaves[p] for p, v in _items(tcache).items())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_axes_name_the_batch_of_every_leaf(arch):
    """The reference's mirror test: the spec mirrors ``init_cache``'s tree
    and names an axis of size B for every leaf (B = 3, a size no stacked
    axis has; and B = attn_every for the hybrid)."""
    _, tcfg, _, _ = _model(arch)
    for B in {3, tcfg.attn_every or 3}:
        cache = tm.init_cache(tcfg, B, 8, kv_cache="int4x2", device="cpu")
        axes = tm.cache_batch_axes(tcfg, "int4x2")
        assert sorted(_items(axes)) == sorted(_items(cache))
        for path, leaf in _items(cache).items():
            assert leaf.shape[_items(axes)[path]] == B, path
    want = {"xlstm-1.3b": {"slstm": 1, "mlstm": 2},
            "zamba2-2.7b": {"attn": 1, "mamba": 2}}[arch]
    for path, ax in _items(tm.cache_batch_axes(tcfg)).items():
        assert ax == want[path[0]], path


@pytest.mark.parametrize("arch", ARCHS)
def test_chunkwise_forward_equals_sequential_decode(arch):
    """The reference's prefill == decode consistency (T = 12) on the port:
    the chunkwise blocks against their recurrences, the hybrid's flash read
    against its cache read."""
    _, tcfg, _, tp = _model(arch)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 12)).astype(np.int32))
    cache = tm.init_cache(tcfg, 2, 16, device="cpu")
    with torch.no_grad():
        full = tm.forward(tp, tcfg, {"tokens": toks})
        dec = torch.cat([tm.decode_step(tp, tcfg, cache, toks[:, t:t + 1])[0]
                         for t in range(12)], 1)
    torch.testing.assert_close(full, dec, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_refuse_active_and_chunked_prefill(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    cache = tm.init_cache(tcfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    msg = "recurrent state advances on every step"
    with pytest.raises(ValueError, match=msg):
        tm.decode_step(tp, tcfg, cache, tok, active=torch.ones(2))
    with pytest.raises(ValueError, match=msg):
        jm.decode_step(jp, jcfg, jm.init_cache(jcfg, 2, 8), jnp.asarray(tok),
                       active=jnp.ones(2))
    with pytest.raises(ValueError, match="attention-only families"):
        tm.prefill_step(tp, tcfg, cache, torch.zeros((2, 4),
                                                     dtype=torch.int32))


def test_hybrid_compile_equals_reference(hybrid_compiled):
    jcm, tcm = hybrid_compiled
    _, tcfg, _, tp = _model("zamba2-2.7b")
    _assert_trees_equal(tcm.params, jcm.params)
    rows = lambda cm: [(r.name, r.policy, r.shape, r.n_layers, r.dense_bytes,
                        r.compressed_bytes, r.container_bytes,
                        r.block_density, r.element_density)
                       for r in cm.report]
    assert sorted(rows(tcm)) == sorted(rows(jcm))
    names = {r.name for r in tcm.report}
    assert "blocks (ssm, not lowered)" in names
    assert not any(n.startswith("blocks/") for n in names)
    assert {n for n in names if n.startswith("shared_attn/")} == {
        f"shared_attn/{s}/{k}" for s, ks in (("attn", "wq wk wv wo"),
                                             ("mlp", "wg wu wd"))
        for k in ks.split()}
    # the Mamba2 super-blocks are the very tensors given
    assert tcm.params["blocks"]["mamba"]["win"]["w"] is \
        tp["blocks"]["mamba"]["win"]["w"]
    assert sorted(tcm.patterns) == sorted(jcm.patterns)
    for kn, pat in jcm.patterns.items():
        np.testing.assert_array_equal(tcm.patterns[kn].bitmap,
                                      np.asarray(pat.bitmap))
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    _assert_trees_equal(tc.decompress_model(tcm), jc.decompress_model(jcm))
    jr, tr = _rules(None)
    jp = _model("zamba2-2.7b")[2]
    assert sorted(rows(tc.compile_model(tp, tcfg, rules=tr, device="cpu"))) \
        == sorted(rows(jc.compile_model(jp, _model("zamba2-2.7b")[0],
                                        rules=jr)))


def test_ssm_compile_is_refused_as_by_the_reference():
    jcfg, tcfg, jp, tp = _model("xlstm-1.3b")
    with pytest.raises(NotImplementedError,
                       match="supports attention/MLP families, got ssm"):
        jc.compile_model(jp, jcfg)
    with pytest.raises(NotImplementedError,
                       match="supports attention/MLP families, got ssm "
                             ".*does not lower the SSM"):
        tc.compile_model(tp, tcfg, device="cpu")


@pytest.mark.parametrize("kv", ["float", "int4x2"])
def test_hybrid_compiled_forward_and_decode_match_reference(hybrid_compiled,
                                                            kv):
    jcm, tcm = hybrid_compiled
    jcfg, tcfg, _, _ = _model("zamba2-2.7b")
    toks = np.random.default_rng(8).integers(0, tcfg.vocab, (2, 9)).astype(
        np.int32)
    jl = jm.forward(jcm.params, jcfg, {"tokens": jnp.asarray(toks)},
                    patterns=jcm.patterns, dispatch="jnp")
    with torch.no_grad():
        tl = tm.forward(tcm.params, tcfg, {"tokens": torch.from_numpy(toks)},
                        patterns=tcm.patterns)
    _close(tl, jl)
    jcache = jm.init_cache(jcfg, 2, 16, kv_cache=kv)
    tcache = tm.init_cache(tcfg, 2, 16, kv_cache=kv, device="cpu")
    for t in range(4):
        jl, jcache = jm.decode_step(jcm.params, jcfg, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    patterns=jcm.patterns, dispatch="jnp",
                                    t_bound=16, bt=8)
        with torch.no_grad():
            tl, tcache = tm.decode_step(tcm.params, tcfg, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]),
                                        patterns=tcm.patterns, t_bound=16,
                                        bt=8)
        _close(tl, jl)
        _check_caches(jcache, tcache)


def _serve(eng, req, prompts, new):
    for i, p in enumerate(prompts):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=new[i]))
    return [r.out for r in sorted(eng.run(), key=lambda r: r.uid)]


ENGINES = [("xlstm-1.3b", "dense", "float", False),
           ("xlstm-1.3b", "int8", "float", False),
           ("zamba2-2.7b", "dense", "float", False),
           ("zamba2-2.7b", "dense", "int4x2", True)]


@pytest.mark.parametrize("arch,mode,kv,compiled", ENGINES)
def test_drip_engine_tokens_match_reference(arch, mode, kv, compiled,
                                            hybrid_compiled):
    jcfg, tcfg, jp, tp = _model(arch, mode)
    jparams, tparams = hybrid_compiled if compiled else (jp, tp)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 19, 3, 12, 1)]
    new = [6, 6, 6, 6, 0]
    kw = dict(batch_slots=3, max_len=64, kv_cache=kv)
    jout = _serve(JEng(jparams, jcfg, dispatch="jnp", **kw), JReq, prompts,
                  new)
    eng = teng.ServeEngine(tparams, tcfg, device="cpu", **kw)
    tout = _serve(eng, teng.Request, prompts, new)
    assert tout == jout
    assert [len(o) for o in tout] == new
    st = eng.stats()
    assert not eng._chunked and st["prefill_steps"] == 0
    assert st["decode_tokens"] == eng.tokens_processed() > 0
    assert eng.cache_bytes() == sum(
        int(np.asarray(v).nbytes) for _, v in tree_items(_np(
            jm.init_cache(jcfg, 3, 64, kv_cache=kv))))


def test_hybrid_churn_with_attn_every_equal_to_slots():
    """The reference's churn case: a long request beside four short ones
    through 2 slots (attn_every == batch_slots, the axis a size guess
    would hit); every request's tokens equal a fresh engine's serving it
    alone, and the reference engine's."""
    jcfg, tcfg, jp, tp = _model("zamba2-2.7b")
    assert tcfg.attn_every == 2
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=4).astype(np.int32)] + [
        rng.integers(1, 128, size=2 + (i % 3)).astype(np.int32)
        for i in range(4)]
    new = [10, 2, 2, 2, 2]
    kw = dict(batch_slots=tcfg.attn_every, max_len=64)
    out = _serve(teng.ServeEngine(tp, tcfg, device="cpu", **kw), teng.Request,
                 prompts, new)
    assert [len(o) for o in out] == new
    for i, p in enumerate(prompts):
        solo = _serve(teng.ServeEngine(tp, tcfg, device="cpu", **kw),
                      teng.Request, [p], [new[i]])
        assert out[i] == solo[0], i
    assert out == _serve(JEng(jp, jcfg, dispatch="jnp", **kw), JReq, prompts,
                         new)


@pytest.mark.parametrize("arch", ARCHS)
def test_drip_engine_ignores_prefill_chunk(arch):
    """A chunk size equal to attn_every (the nastiest alignment) is
    ignored: the drip runs, and each request's tokens equal a fresh solo
    engine's."""
    _, tcfg, _, tp = _model(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, size=3 + i).astype(np.int32)
               for i in range(3)]
    eng = teng.ServeEngine(tp, tcfg, batch_slots=2, max_len=32,
                           prefill_chunk=tcfg.attn_every or 2, device="cpu")
    assert not eng._chunked
    out = _serve(eng, teng.Request, prompts, [3, 3, 3])
    assert eng.stats()["prefill_steps"] == 0
    for p, o in zip(prompts, out):
        solo = teng.ServeEngine(tp, tcfg, batch_slots=2, max_len=32,
                                device="cpu")
        assert _serve(solo, teng.Request, [p], [3]) == [o]
