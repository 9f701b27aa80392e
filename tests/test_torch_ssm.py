"""The port's SSM blocks and synthetic linear init vs the JAX reference, at
the reference's ``reduced_config`` sizes in f32, with the reference's
weights carried across as numpy.

* ``mlstm_apply`` / ``slstm_apply`` / ``mamba2_apply``: the chunkwise form
  (full sequence, T = 1, 7 and 300: one chunk, then two with a ragged
  tail) and the recurrence stepped T times from a zero state, outputs and
  returned states within ``REL · max|ref|``;
* ``_mamba_proj`` with and without a conv state; the softplus and
  log-sigmoid against ``jax.nn``'s, past torch's softplus threshold;
* every synthetic init mode: leaf names, shapes and dtypes against the
  reference's ``init_leaves`` (and stacked over leading axes); ``lin_apply``
  on a synthetic sparse / gsparse leaf with no side-table falls back to the
  config's shared pattern and gives the reference's output;
* ``attn_init`` / ``mlp_init`` under ``"dense"`` draw the tensors the
  port drew before the init modes existed.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.core.families._util import he_init  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402

REL = 1e-5        # of the largest reference value
# the chunkwise mLSTM at T = 300 sums 256-term chunk products in another
# order than XLA; the normaliser's division amplifies that to ~7e-6 of the
# largest output at one block
MLSTM_LONG_REL = 2e-5
TS = [1, 7, 300]


def _np(tree):
    """A reference tree as numpy, keys in their order."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _index(tree, *idx):
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _close(t, j, rel=REL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(t - j).max()) <= rel * scale, \
        float(np.abs(t - j).max()) / scale


@pytest.fixture(scope="module")
def xlstm():
    jcfg, tcfg = j_reduced("xlstm-1.3b"), t_reduced("xlstm-1.3b")
    jp = _np(jm.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp


@pytest.fixture(scope="module")
def zamba():
    jcfg, tcfg = j_reduced("zamba2-2.7b"), t_reduced("zamba2-2.7b")
    jp = _np(jm.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp


def _block(model, name):
    """(reference cfg, port cfg, reference block params, port block params,
    apply pair, cache-init pair) of one SSM block of layer 0."""
    jcfg, tcfg, jp = model
    blocks = jp["blocks"]
    if name == "slstm":
        p = _index(blocks["slstm"], 0)
        fns = (js.slstm_apply, ts.slstm_apply)
        caches = (js.slstm_cache_init, ts.slstm_cache_init)
    elif name == "mlstm":
        p = _index(blocks["mlstm"], 0, 1)
        fns = (js.mlstm_apply, ts.mlstm_apply)
        caches = (js.mlstm_cache_init, ts.mlstm_cache_init)
    else:
        p = _index(blocks["mamba"], 1, 0)
        # a nonzero decay, skip and dt bias, so every term is exercised
        rng = np.random.default_rng(9)
        H = p["a_log"].shape[0]
        p = dict(p, a_log=rng.normal(size=H).astype(np.float32) * 0.5,
                 d_skip=rng.normal(size=H).astype(np.float32),
                 dt_bias=rng.normal(size=H).astype(np.float32))
        fns = (js.mamba2_apply, ts.mamba2_apply)
        caches = (js.mamba2_cache_init, ts.mamba2_cache_init)
    return jcfg, tcfg, p, interop.params_from_numpy(p, "cpu"), fns, caches


BLOCKS = [("xlstm", "slstm"), ("xlstm", "mlstm"), ("zamba", "mamba")]


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("model,name", BLOCKS)
def test_chunkwise_form_matches_reference(request, model, name, T):
    jcfg, tcfg, jp, tp, (jf, tf), _ = _block(request.getfixturevalue(model),
                                            name)
    x = np.random.default_rng(T).standard_normal(
        (2, T, tcfg.d_model)).astype(np.float32)
    jy, jc = jf(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        ty, tc = tf(tp, tcfg, torch.from_numpy(x))
    assert jc is None and tc is None
    _close(ty, jy, MLSTM_LONG_REL if (name, T) == ("mlstm", 300) else REL)


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("model,name", BLOCKS)
def test_recurrent_form_and_state_match_reference(request, model, name, T):
    """T steps of the recurrence from a zero state: every step's output
    and the final state; the port's state is updated in place."""
    jcfg, tcfg, jp, tp, (jf, tf), (jci, tci) = _block(
        request.getfixturevalue(model), name)
    B = 2
    x = np.random.default_rng(T + 1).standard_normal(
        (B, T, tcfg.d_model)).astype(np.float32)
    step = jax.jit(lambda c, xt: jf(jp, jcfg, xt, c))
    jc, tc = jci(jcfg, B), tci(tcfg, B, device="cpu")
    leaves = {k: v for k, v in tc.items()}
    jys, tys = [], []
    with torch.no_grad():
        for t in range(T):
            jy, jc = step(jc, jnp.asarray(x[:, t:t + 1]))
            ty, tc2 = tf(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
            assert tc2 is tc
            jys.append(np.asarray(jy))
            tys.append(ty)
    assert all(tc[k] is v for k, v in leaves.items())
    _close(torch.cat(tys, 1), np.concatenate(jys, 1))
    for k in jc:
        _close(tc[k], jc[k])


@pytest.mark.parametrize("model,name", BLOCKS)
def test_chunkwise_equals_recurrence_on_the_port(request, model, name):
    """The reference's chunkwise == recurrent equivalence, on the port
    alone, across a chunk boundary (T = 300)."""
    _, tcfg, _, tp, (_, tf), (_, tci) = _block(
        request.getfixturevalue(model), name)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 300, tcfg.d_model)).astype(np.float32))
    cache = tci(tcfg, 2, device="cpu")
    with torch.no_grad():
        full, _ = tf(tp, tcfg, x)
        rec = torch.cat([tf(tp, tcfg, x[:, t:t + 1], cache)[0]
                         for t in range(300)], 1)
    assert bool(torch.isfinite(full).all())
    torch.testing.assert_close(full, rec, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("T", [2, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_proj_matches_reference(zamba, T, with_state):
    jcfg, tcfg, jp, tp, _, _ = _block(zamba, "mamba")
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    d_xbc = tcfg.d_inner + 2 * tcfg.ssm_state
    st = rng.standard_normal((2, 3, d_xbc)).astype(np.float32) \
        if with_state else None
    jo = js._mamba_proj(jp, jcfg, jnp.asarray(x),
                        None if st is None else jnp.asarray(st))
    to = ts._mamba_proj(tp, tcfg, torch.from_numpy(x),
                        None if st is None else torch.from_numpy(st))
    for j, t in zip(jo, to):
        if j is None:
            assert t is None   # a zero-start sequence shorter than 3
            continue
        _close(t, j)


def test_softplus_and_log_sigmoid_match_jax_past_the_threshold():
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [19.9, 20.0, 20.1, 25.0, 88.0, -88.0]]
                       ).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(ts._softplus(tx).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts._log_sigmoid(tx).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------ synthetic init


def _ref_modes():
    modes = {}
    for fam in jreg.all_families():
        modes.update(fam.init_modes)
    return sorted(modes)


def test_init_modes_are_the_references():
    assert sorted(treg.init_modes()) == _ref_modes()


@pytest.mark.parametrize("mode", _ref_modes())
def test_init_mode_leaves_match_reference(mode):
    """Names, shapes and dtypes of one leaf per mode (K 64, N 128) against
    the reference's ``init_leaves``, with the pattern each mode's
    ``lin_init`` picks; stacked over (2, 3) the same leaves gain the
    axes."""
    jcfg = dataclasses.replace(j_reduced("llama3.2-1b"), linear_mode=mode,
                               sparse_block=(16, 32), sparse_density=0.5)
    tcfg = dataclasses.replace(t_reduced("llama3.2-1b"), linear_mode=mode,
                               sparse_block=(16, 32), sparse_density=0.5)
    K, N = 64, 128
    jpat, tpat = jb._pattern(jcfg, K, N), tb._pattern(tcfg, K, N)
    if mode.startswith("sparse"):
        np.testing.assert_array_equal(tpat.bitmap, np.asarray(jpat.bitmap))
        assert tpat.block == tuple(jpat.block)
    else:
        assert tpat == jpat
    j = jreg.init_leaves(mode, jax.random.PRNGKey(0), K, N,
                         dtype=jnp.float32, pattern=jpat)
    gen = torch.Generator().manual_seed(0)
    t = treg.init_leaves(mode, gen, K, N, dtype=torch.float32, pattern=tpat)
    sig = lambda d, conv: {k: (tuple(v.shape), conv(v.dtype))
                           for k, v in d.items()}
    tname = lambda dt: str(dt).replace("torch.", "")
    assert sig(t, tname) == sig(j, lambda dt: np.dtype(dt).name)
    for k, v in j.items():
        if np.dtype(v.dtype).kind in "iu" and k not in ("w_bfpe",):
            assert int(t[k].abs().max()) <= 127
    ts_ = treg.init_leaves(mode, gen, K, N, dtype=torch.float32,
                           pattern=tpat, lead=(2, 3))
    assert sig(ts_, tname) == {k: ((2, 3) + s, d)
                               for k, (s, d) in sig(t, tname).items()}
    # scales and exponents are constants: equal to the reference's
    for k, v in j.items():
        if k in ("w_s", "w_pcs", "w_bfpe"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(v))
    # lin_init: the config's mode, the same leaves
    lp = tb.lin_init(gen, tcfg, K, N)
    assert sig(lp, tname) == sig(t, tname)


def test_lin_init_falls_back_to_dense_where_the_pattern_does_not_tile():
    tcfg = dataclasses.replace(t_reduced("llama3.2-1b"), linear_mode="sparse",
                               sparse_block=(16, 32), sparse_density=0.5)
    gen = torch.Generator().manual_seed(0)
    assert tb._pattern(tcfg, 40, 128) is None   # 40 % 16
    assert set(tb.lin_init(gen, tcfg, 40, 128)) == {"w"}
    gcfg = dataclasses.replace(tcfg, linear_mode="gsparse")
    assert tb._pattern(gcfg, 40, 128) is None   # groups of 20 rows
    assert tb._pattern(gcfg, 64, 128) == 2      # groups of 32 x 64
    assert set(tb.lin_init(gen, gcfg, 40, 128)) == {"w"}


@pytest.mark.parametrize("mode", ["sparse", "sparse_int8", "gsparse",
                                  "gsparse_int8", "int8"])
def test_lin_apply_takes_the_config_pattern_without_a_side_table(mode):
    """A synthetic leaf (the reference's ``lin_init`` draw, carried across)
    with no compiled side-table: ``lin_apply`` runs it on the config's
    shared pattern, as the reference's does."""
    kw = dict(linear_mode=mode, sparse_block=(16, 32), sparse_density=0.5)
    jcfg = dataclasses.replace(j_reduced("llama3.2-1b"), **kw)
    tcfg = dataclasses.replace(t_reduced("llama3.2-1b"), **kw)
    K, N = 64, 128
    jp = jb.lin_init(jax.random.PRNGKey(3), jcfg, K, N)
    tp = interop.params_from_numpy(_np(jp), "cpu")
    assert set(tp) == set(jp) and "w" not in tp
    x = np.random.default_rng(0).standard_normal((2, 5, K)).astype(np.float32)
    jy = jb.lin_apply(jcfg, jp, jnp.asarray(x), K, N, dispatch="jnp")
    ty = tb.lin_apply(tcfg, tp, torch.from_numpy(x), K, N)
    _close(ty, jy)


def test_dense_attn_and_mlp_init_draw_the_earlier_tensors():
    """Under ``linear_mode="dense"`` ``attn_init`` / ``mlp_init`` draw, in
    the same generator order, what the port drew before the init modes:
    ``he_init`` of each (L, K, N) stack, zero biases."""
    cfg = dataclasses.replace(t_reduced("qwen1.5-4b"), qkv_bias=True)
    assert cfg.linear_mode == "dense"
    L, D, F_ = 2, cfg.d_model, cfg.d_ff
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(7)
    got = {**tb.attn_init(gen, cfg, L), **tb.mlp_init(gen, cfg, L)}
    ref_gen = torch.Generator().manual_seed(7)
    shapes = [("wq", D, H * Dh, True), ("wk", D, Hkv * Dh, True),
              ("wv", D, Hkv * Dh, True), ("wo", H * Dh, D, False),
              ("wg", D, F_, False), ("wu", D, F_, False), ("wd", F_, D, False)]
    for name, K, N, bias in shapes:
        w = he_init(ref_gen, (L, K, N), torch.float32, K)
        assert torch.equal(got[name]["w"], w), name
        assert set(got[name]) == ({"w", "b"} if bias else {"w"})
        if bias:
            assert torch.equal(got[name]["b"], torch.zeros((L, N)))
    assert math.isclose(float(got["wq"]["w"].std()), 1 / math.sqrt(D),
                        rel_tol=0.1)
