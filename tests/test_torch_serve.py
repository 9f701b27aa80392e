"""Port transformer layers, cache layout, the serving engine's lifecycle
and the int4 / int4x2 cache contract vs the JAX reference.  The steps and
the engine's tokens against the reference's live in
``test_torch_serve_steps.py`` and ``test_torch_serve_engine.py``; the
shared cases and tolerances in ``tests/_serve.py``.

Logits: f32 ``rtol=1e-5, atol=1e-5`` (the two packages sum matmul products
in different orders).  Integer cache containers (packed codes) must be
equal byte for byte; their f32 scales within the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serve import (  # noqa: E402,F401
    POLICIES, TOL, check_caches, one_thread, pair, serve, tiny)
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serve.engine import Request as TReq, ServeEngine as TEng  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("kv", ["float", "int4", "int4x2"])
def test_kv_insert_clamps_a_full_slot_like_the_reference(tiny, kv):
    """A slot whose length equals max_len writes its (inactive) garbage row
    at max_len - 1, as ``dynamic_update_slice`` clamps the start."""
    jcfg, tcfg, jp, tp, jcm, tcm = tiny
    B, T = 2, 8
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    toks = np.arange(16, dtype=np.int32).reshape(B, 8) % 96
    nv = np.array([8, 3], np.int32)
    jl, jcache = jm.prefill_step(jp, jcfg, jcache, jnp.asarray(toks),
                                 dispatch="jnp", n_valid=jnp.asarray(nv), bt=8)
    tl, tcache = tm.prefill_step(tp, tcfg, tcache, torch.from_numpy(toks),
                                 n_valid=torch.from_numpy(nv), bt=8)
    assert tcache["length"][:, 0].tolist() == [T, T]
    tok = np.array([[5], [7]], np.int32)
    act = np.array([0, 1], np.int32)
    jl, jcache = jm.decode_step(jp, jcfg, jcache, jnp.asarray(tok),
                                dispatch="jnp", active=jnp.asarray(act), bt=8)
    tl, tcache = tm.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                                active=torch.from_numpy(act), bt=8)
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **TOL)
    check_caches(jcache, tcache)
    # the clamp in isolation: rows land at [T - C, T)
    c = torch.zeros((1, 4, 1))
    tb._kv_insert(c, torch.ones((1, 2, 1)), torch.tensor([4]))
    assert c[0, :, 0].tolist() == [0, 0, 1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """Norms, RoPE and the float-cache reads round where the reference
    rounds (bf16 inputs: the same casts give the same bf16 values up to one
    rounding step, 2^-7 relative)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def both(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)

    def close(t, j):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)

    xj, xt = both(rng.normal(size=(2, 5, 32)))
    gj, gt = both(rng.normal(size=32))
    bj, bt = both(rng.normal(size=32))
    close(tl.rmsnorm({"g": gt}, xt), jl.rmsnorm({"g": gj}, xj))
    close(tl.layernorm({"g": gt, "b": bt}, xt),
          jl.layernorm({"g": gj, "b": bj}, xj))
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    qj, qt = both(rng.normal(size=(2, 5, 4, 16)))
    close(tl.apply_rope(qt, torch.from_numpy(pos), 500000.0),
          jl.apply_rope(qj, jnp.asarray(pos), 500000.0))
    kj, kt = both(rng.normal(size=(2, 12, 2, 16)))
    vj, vt = both(rng.normal(size=(2, 12, 2, 16)))
    q1j, q1t = both(rng.normal(size=(2, 1, 4, 16)))
    length = np.array([3, 12], np.int32)
    close(tl.decode_attention(q1t, kt, vt, torch.from_numpy(length)),
          jl.decode_attention(q1j, kj, vj, jnp.asarray(length)))
    lengths = np.array([[1, 2, 3, 4, 5], [8, 9, 10, 11, 12]], np.int32)
    close(tl.prefill_attention(qt, kt, vt, torch.from_numpy(lengths)),
          jl.prefill_attention(qj, kj, vj, jnp.asarray(lengths)))


def test_init_shapes_and_cache_axes_match_reference():
    jcfg, tcfg, jp, tp = pair()
    ours = tm.init_params(tcfg, seed=3, device="cpu")
    flat = lambda t, p=(): [x for k, v in t.items() for x in (
        flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)])]
    shapes = lambda t: sorted((p, tuple(v.shape)) for p, v in flat(t))
    assert shapes(ours) == shapes(jax.tree_util.tree_map(np.asarray, jp))
    for kv in ("float", "int4", "int4x2"):
        jc_ = jax.tree_util.tree_map(np.asarray, jm.init_cache(jcfg, 2, 8, kv))
        tc_ = tm.init_cache(tcfg, 2, 8, kv, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc_.items()} == \
            {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in tc_.items()}
        assert tm.cache_batch_axes(tcfg, kv) == jm.cache_batch_axes(jcfg, kv)
    with pytest.raises(ValueError, match="unknown kv_cache container"):
        tm.init_cache(tcfg, 2, 8, "int8", device="cpu")
    # the SSM and hybrid families (once refused here) init the reference's
    # layout, nested caches and axes included
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        jr, tr = j_reduced(arch), t_reduced(arch)
        jpr = jm.init_params(jax.random.PRNGKey(0), jr)
        assert shapes(tm.init_params(tr, seed=3, device="cpu")) == \
            shapes(jax.tree_util.tree_map(np.asarray, jpr))
        assert shapes(tm.init_cache(tr, 2, 8, "int4x2", device="cpu")) == \
            shapes(jax.tree_util.tree_map(np.asarray, jm.init_cache(
                jr, 2, 8, "int4x2")))
        assert tm.cache_batch_axes(tr, "int4x2") == \
            jm.cache_batch_axes(jr, "int4x2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.init_params(tcfg)
    cfg = get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.param_dtype) == \
        (16, 2048, 32, 8, 64, 8192, 128256, "bfloat16")
    assert get_config("llama3_2_1b") is cfg


def test_serve_engine_lifecycle():
    jcfg, tcfg, jp, tp = pair()
    eng = TEng(tp, tcfg, batch_slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(TReq(uid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(TReq(uid=1, prompt=np.zeros(10, np.int32),
                        max_new_tokens=8))
    eng.submit(TReq(uid=2, prompt=np.arange(5, dtype=np.int32),
                    max_new_tokens=0))
    eng.submit(TReq(uid=3, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=3))
    eng.step()
    done = eng.run()
    assert sorted(r.uid for r in done) == [2, 3]
    by = {r.uid: r for r in done}
    assert by[2].out == [] and len(by[3].out) == 3
    assert by[3].t_submit <= by[3].t_first <= by[3].t_done
    st = eng.stats()
    assert len(st["prefill_ms"]) == st["prefill_steps"] > 0
    with pytest.raises(ValueError, match="engine runs on"):
        TEng(tp, tcfg, device="meta")
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        TEng(tp, tcfg, device="cpu", capture=True)
    assert not TEng(tp, tcfg, device="cpu").capture
    assert not TEng(tp, tcfg, device="cpu", capture=False).capture
    assert st["graphs"] == 0 and st["capture_s"] == 0.0


def test_int4_and_int4x2_caches_give_the_same_bits(tiny):
    """The port's counterpart of the reference's container contract: the
    int4 (int8 codes) and int4x2 (packed) caches hold the same codes and
    scales, and their reads give bitwise equal logits, prefill and decode,
    under both reads."""
    from repro_torch.core.quant import unpack_int4
    jcfg, tcfg, jp, tp, jcm, tcm = tiny
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 96, size=(2, 8)).astype(np.int32))
    nv = torch.tensor([8, 3], dtype=torch.int32)
    for read in ("fused", "unpack"):
        logits, caches = {}, {}
        for kv in ("int4", "int4x2"):
            cache = tm.init_cache(tcfg, 2, 32, kv, device="cpu")
            out = [tm.prefill_step(tcm.params, tcfg, cache, toks,
                                   patterns=tcm.patterns, n_valid=nv,
                                   t_bound=16, bt=8, packed_read=read)[0]]
            for step in range(4):
                tok = torch.tensor([[3 + step], [7]], dtype=torch.int32)
                out.append(tm.decode_step(tcm.params, tcfg, cache, tok,
                                          patterns=tcm.patterns, t_bound=32,
                                          bt=8, packed_read=read)[0])
            logits[kv], caches[kv] = out, cache
        for a, b in zip(logits["int4"], logits["int4x2"]):
            assert torch.equal(a, b)
        c4, c42 = caches["int4"], caches["int4x2"]
        for q, p_ in (("k_q", "k_p"), ("v_q", "v_p")):
            assert torch.equal(c4[q], unpack_int4(c42[p_], tcfg.head_dim,
                                                  axis=-1))
        for k in ("k_s", "v_s", "length"):
            assert torch.equal(c4[k], c42[k])


def test_attn_apply_rejects_an_unknown_read(tiny):
    jcfg, tcfg, jp, tp, jcm, tcm = tiny
    cache = tm.init_cache(tcfg, 1, 8, "int4", device="cpu")
    with pytest.raises(ValueError, match="unknown packed_read"):
        tm.decode_step(tp, tcfg, cache, torch.zeros((1, 1), dtype=torch.int32),
                       packed_read="dense")


def test_launch_counts_round_trip():
    """The counters the engine adds on each replay of a captured step."""
    from repro_torch import kernels
    counts = kernels.launch_counts()
    assert counts["flash_attention.decode_packed:launches_split"] \
        == tdp.launches_split
    assert len(counts) == sum(len(v) for v in kernels.LAUNCH_COUNTERS.values())
    kernels.add_launch_counts({"quant_matmul.kernel:launches_thin": 3,
                               "sparse_matmul.kernel:conv_launches": 2})
    after = kernels.launch_counts()
    kernels.add_launch_counts({"quant_matmul.kernel:launches_thin": -3,
                               "sparse_matmul.kernel:conv_launches": -2})
    assert after["quant_matmul.kernel:launches_thin"] \
        == counts["quant_matmul.kernel:launches_thin"] + 3
    assert after["sparse_matmul.kernel:conv_launches"] == tsk.conv_launches + 2
    assert kernels.launch_counts() == counts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: captured steps run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_engine_matches_eager_on_the_card(cuda_device):
    """Captured and eager engines serve the same tokens and launch the same
    kernels; one graph per phase and bucket."""
    jcfg, tcfg, jp, tp = pair(d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=64, d_ff=512, vocab=512,
                               param_dtype="bfloat16")
    tcm = tc.compile_model(interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cuda_device), tcfg,
        rules=tc.CompileRules(block=(128, 128), block_density=0.5,
                              in_block_density=0.5, min_weight_elems=0,
                              quant_bits=4, policies=POLICIES),
        device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=int(n)).astype(np.int32)
               for n in (3, 17, 40, 9, 33)]
    outs, launches = {}, {}
    for capture in (True, False):
        before = tdp.launches
        eng, outs[capture] = serve(
            TEng, TReq, tcm, tcfg, prompts, device=cuda_device,
            batch_slots=3, max_len=64, kv_cache="int4x2", capture=capture)
        launches[capture] = tdp.launches - before
        assert (eng.stats()["graphs"] > 0) == capture
    assert outs[True] == outs[False]
    assert launches[True] == launches[False] > 0
