"""Plain versions of the port's kernels vs the JAX Pallas kernels (interpret
mode) and the reference's jnp oracles, on identical numpy inputs.

On the CPU every wrapper takes its plain version and launches nothing; the
CUDA kernels themselves are held against the plain versions by the
``gpu``-marked test at the end (and by ``chip_smoke.py``) on a card.

Tolerance: f32 ``rtol=1e-5`` with ``atol=1e-5`` (not 1e-6): the Pallas
kernels sum each K-block's products and then the blocks, the plain versions
sum all K at once, so outputs of size O(1) differ by a few f32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import decode_packed as jdp  # noqa: E402
from repro.kernels.quant_matmul.kernel import quant_matmul as j_qmm  # noqa: E402
from repro.kernels.quant_matmul.ref import quant_matmul_ref as j_qmm_ref  # noqa: E402
from repro.kernels.sparse_matmul import kernel as jsk  # noqa: E402
from repro.kernels.sparse_matmul.ref import block_sparse_matmul_ref as j_bsm_ref  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core.quant import PackedTensor, pack_codes  # noqa: E402
from repro_torch.core.sparsity import CompressedLinear, pattern_from_bitmap  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.quant_matmul.ops import quant_linear  # noqa: E402
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.kernels.sparse_matmul.ops import sparse_linear  # noqa: E402
from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = [None, "relu", "silu", "gelu", ("trelu", 0.1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sparse_case(container, seed, *, empty=False, nR=3, nC=3, bk=8, bn=16):
    rng = np.random.default_rng(seed)
    bitmap = rng.random((nR, nC)) < 0.6
    bitmap[0, 0] = True
    bitmap[:, 1] = False            # an absent output column block
    if empty:
        bitmap[:] = False
    rows, cols = np.nonzero(bitmap)
    P = rows.size
    scales = None
    if container == "f32":
        vals = rng.normal(size=(P, bk, bn)).astype(np.float32) / 4
    else:
        qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
        vals = rng.integers(-qm, qm + 1, size=(P, bk, bn)).astype(np.int8)
        scales = (rng.random(nC * bn) / (qm * 4)).astype(np.float32)
    x = rng.normal(size=(8, nR * bk)).astype(np.float32)
    bias = rng.normal(size=nC * bn).astype(np.float32)
    return x, vals, scales, bias, rows, cols, nR, nC


@pytest.mark.parametrize("container,act,empty", [
    ("f32", "relu", False), ("int8", "silu", False), ("int4x2", "gelu", False),
    ("int2x4", ("trelu", 0.1), False), ("int4x2", None, True),
])
def test_block_sparse_plain_matches_pallas_interpret(container, act, empty):
    x, vals, scales, bias, rows, cols, nR, nC = _sparse_case(
        container, seed=len(container), empty=empty)
    packed, blocks_j, blocks_t = False, jnp.asarray(vals), _t(vals)
    if container in ("int4x2", "int2x4"):
        packed = container
        bits = 4 if container == "int4x2" else 2
        blocks_t = pack_codes(_t(vals), axis=1, bits=bits)
        blocks_j = jnp.asarray(blocks_t.numpy())
    kw = dict(n_row_blocks=nR, n_col_blocks=nC, activation=act,
              bias=jnp.asarray(bias),
              scales=None if scales is None else jnp.asarray(scales))
    ref = jsk.block_sparse_matmul(jnp.asarray(x), blocks_j, rows, cols, bm=8,
                                  interpret=True, packed=packed, **kw)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    y = tsk.block_sparse_matmul(_t(x), blocks_t, sched,
                                scales=None if scales is None else _t(scales),
                                bias=_t(bias), activation=act, packed=packed)
    assert y.dtype == torch.float32 and tuple(y.shape) == tuple(ref.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_block_sparse_ref_matches_reference_oracle(act):
    x, vals, scales, bias, rows, cols, nR, nC = _sparse_case("int8", seed=9)
    kw = dict(n_row_blocks=nR, n_col_blocks=nC, activation=act)
    ref = j_bsm_ref(jnp.asarray(x), jnp.asarray(vals), rows, cols,
                    scales=jnp.asarray(scales), bias=jnp.asarray(bias), **kw)
    y = block_sparse_matmul_ref(_t(x), _t(vals), rows, cols, scales=_t(scales),
                                bias=_t(bias), **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_quant_ref_matches_reference_oracle(act):
    rng = np.random.default_rng(4)
    codes = rng.integers(-127, 128, size=(24, 16)).astype(np.int8)
    scales = (rng.random(16) / 512).astype(np.float32)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    ref = j_qmm_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
                    bias=jnp.asarray(bias), activation=act)
    y = quant_matmul_ref(_t(x), _t(codes), _t(scales), bias=_t(bias),
                         activation=act)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


def test_activations_match_reference_formulas():
    v = np.linspace(-6, 6, 301).astype(np.float32)
    for act in ACTS:
        np.testing.assert_allclose(
            tsk.apply_activation(_t(v), act).numpy(),
            np.asarray(jsk.apply_activation(jnp.asarray(v), act)),
            rtol=1e-6, atol=1e-6)
    # gelu is the tanh form (jax's default), not torch's erf default
    assert abs(float(tsk.apply_activation(torch.tensor(1.0), "gelu"))
               - float(jax.nn.gelu(1.0, approximate=True))) < 1e-6
    with pytest.raises(ValueError, match="activation"):
        tsk.act_args("swish")


@pytest.mark.parametrize("container,act", [("int8", "relu"),
                                           ("int4x2", None),
                                           ("int2x4", "gelu")])
def test_quant_plain_matches_pallas_interpret(container, act):
    rng = np.random.default_rng(3)
    K, N, M = 32, 32, 8
    qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
    codes = rng.integers(-qm, qm + 1, size=(K, N)).astype(np.int8)
    scales = (rng.random(N) / (qm * 4)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    packed, w = False, _t(codes)
    if container != "int8":
        packed = container
        w = pack_codes(_t(codes), axis=0,
                       bits=4 if container == "int4x2" else 2)
    ref = j_qmm(jnp.asarray(x), jnp.asarray(w.numpy()), jnp.asarray(scales),
                jnp.asarray(bias), bm=8, bn=16, bk=16, interpret=True,
                activation=act, packed=packed)
    y = tqk.quant_matmul(_t(x), w, _t(scales), _t(bias), activation=act,
                         packed=packed)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


def _attn_case(B, C, T, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    codes_k = rng.integers(-7, 8, size=(B, T, Hkv, Dh)).astype(np.int8)
    codes_v = rng.integers(-7, 8, size=(B, T, Hkv, Dh)).astype(np.int8)
    k_p = pack_codes(_t(codes_k), axis=-1, bits=4).numpy()
    v_p = pack_codes(_t(codes_v), axis=-1, bits=4).numpy()
    k_s = (rng.random((B, T, Hkv)) / 7).astype(np.float32)
    v_s = (rng.random((B, T, Hkv)) / 7).astype(np.float32)
    q = rng.normal(size=(B, C, H, Dh)).astype(np.float32)
    return q, k_p, v_p, k_s, v_s


def test_packed_attention_plain_matches_pallas_interpret():
    # slot 0 one live row (dead tiles), slot 1 a ragged last tile
    q, k_p, v_p, k_s, v_s = _attn_case(2, 1, 40, 4, 2, 8, seed=0)
    length = np.array([1, 37], np.int32)
    ref = jdp.packed_decode_attention(
        *(jnp.asarray(a) for a in (q, k_p, v_p, k_s, v_s)),
        jnp.asarray(length), bt=16, interpret=True)
    y = tdp.tiled_packed_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                                   _t(length[:, None]), bt=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    # the wrapper takes the plain version for CPU tensors
    y2 = tdp.packed_decode_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                                     _t(length[:, None]), bt=16)
    np.testing.assert_array_equal(y2.numpy(), y.numpy())


@pytest.mark.parametrize("C,bt", [(1, 16), (4, 8), (4, 32)])
def test_int8_code_read_matches_reference_twin(C, bt):
    """The int4 container's read (``packed=False``: int8 codes, one a
    byte) against the reference's twin on the same codes; the same bits as
    the packed read of those codes; and the CPU wrapper and dispatch take
    the plain version for it."""
    from repro_torch.core.quant import unpack_int4
    B, T, Dh = 2, 40, 8
    q, k_p, v_p, k_s, v_s = _attn_case(B, C, T, 4, 2, Dh, seed=20 + bt)
    k_q, v_q = (unpack_int4(_t(a), Dh, axis=-1).numpy() for a in (k_p, v_p))
    lengths = (np.array([[1], [37]]) + np.arange(C)).astype(np.int32)
    ref = jdp.tiled_packed_attention(
        *(jnp.asarray(a) for a in (q, k_q, v_q, k_s, v_s)),
        jnp.asarray(lengths), bt=bt, packed=False)
    y = tdp.tiled_packed_attention(*(_t(a) for a in (q, k_q, v_q, k_s, v_s)),
                                   _t(lengths), bt=bt, packed=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    packed = tdp.tiled_packed_attention(
        *(_t(a) for a in (q, k_p, v_p, k_s, v_s)), _t(lengths), bt=bt)
    np.testing.assert_array_equal(y.numpy(), packed.numpy())
    before = tdp.launches
    y2 = tdp.packed_decode_attention(
        *(_t(a) for a in (q, k_q, v_q, k_s, v_s)), _t(lengths), bt=bt,
        packed=False)
    y3 = td.attn_packed_dispatch(*(_t(a) for a in (q, k_q, v_q, k_s, v_s)),
                                 _t(lengths), packed=False, bt=bt)
    assert tdp.launches == before
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    np.testing.assert_array_equal(y3.numpy(), y.numpy())


@pytest.mark.parametrize("bt", [8, 32])
def test_packed_attention_chunk_matches_reference_twin(bt):
    B, C, T = 2, 4, 24
    q, k_p, v_p, k_s, v_s = _attn_case(B, C, T, 4, 2, 8, seed=bt)
    lengths = np.array([[1, 2, 3, 4], [17, 18, 19, 19]], np.int32)
    ref = jdp.tiled_packed_attention(
        *(jnp.asarray(a) for a in (q, k_p, v_p, k_s, v_s)),
        jnp.asarray(lengths), bt=bt)
    y = tdp.tiled_packed_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                                   _t(lengths), bt=bt)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    # dead tiles leave the state untouched: a shorter extent reads the same
    # (up to the sum order of the shorter tile's products)
    y20 = tdp.tiled_packed_attention(
        _t(q), *(_t(a)[:, :20] for a in (k_p, v_p, k_s, v_s)), _t(lengths),
        bt=bt)
    np.testing.assert_allclose(y20.numpy(), y.numpy(), **TOL)


def test_ops_route_thin_m_and_unpack_bn_axis_containers():
    rng = np.random.default_rng(5)
    bitmap = np.array([[1, 0], [1, 1]], bool)
    pat = pattern_from_bitmap((6, 8), (3, 4), bitmap)
    codes = rng.integers(-7, 8, size=(3, 3, 4)).astype(np.int8)
    scales = _t((rng.random(8) / 7).astype(np.float32))
    # bk = 3 is odd: the container packs along bn (axis 2)
    cl = CompressedLinear(pattern=pat, blocks=PackedTensor(
        data=pack_codes(_t(codes), axis=2, bits=4), shape=(3, 3, 4), axis=2,
        bits=4), scales=scales, bits=4)
    x = _t(rng.normal(size=(2, 5, 6)).astype(np.float32))
    y = sparse_linear(x, cl)
    ref = sparse_linear(x, CompressedLinear(pattern=pat, blocks=_t(codes),
                                            scales=scales), use_kernel=False)
    assert tuple(y.shape) == (2, 5, 8)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
    with pytest.raises(ValueError, match="feature dim"):
        sparse_linear(x[..., :5], cl)
    q = PackedTensor(data=pack_codes(_t(codes.reshape(9, 4)[:8]), axis=0,
                                     bits=4), shape=(8, 4), axis=0,
                     scales=scales[:4], bits=4)
    xq = _t(rng.normal(size=(3, 8)).astype(np.float32))
    np.testing.assert_allclose(quant_linear(xq, q).numpy(),
                               quant_linear(xq, q, use_kernel=False).numpy(),
                               **TOL)


def test_cpu_calls_launch_nothing_and_kernel_mode_raises():
    for mod in (tsk, tqk, tdp):
        mod.launches = 0
    tqk.launches_thin = tqk.launches_tiled = 0
    test_block_sparse_plain_matches_pallas_interpret("int4x2", "gelu", False)
    test_quant_plain_matches_pallas_interpret("int4x2", None)
    test_packed_attention_plain_matches_pallas_interpret()
    assert (tsk.launches, tqk.launches, tdp.launches) == (0, 0, 0)
    assert (tqk.launches_thin, tqk.launches_tiled) == (0, 0)
    q, k_p, v_p, k_s, v_s = _attn_case(1, 1, 8, 2, 1, 8, seed=1)
    args = [_t(a) for a in (q, k_p, v_p, k_s, v_s)] + [torch.ones(1, 1,
                                                                  dtype=torch.int32)]
    with pytest.raises(ValueError, match="kernel"):
        td.attn_packed_dispatch(*args, packed=True, dispatch="kernel")
    twin = td.attn_packed_dispatch(*args, packed=True, dispatch="twin")
    auto = td.attn_packed_dispatch(*args, packed=True, dispatch="auto")
    np.testing.assert_array_equal(twin.numpy(), auto.numpy())


# ------------------------------------------------- thin-M quant_matmul plan


def _split_rows(plan, rows):
    """The byte-row range of each split, as the thin-M kernel cuts them."""
    return [(s * plan.rows_per_split,
             min((s + 1) * plan.rows_per_split, rows))
            for s in range(plan.k_splits)]


@pytest.mark.parametrize("ratio", [1, 2, 4])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 512), (8192, 96),
                                 (8192, 2048), (512, 320), (8, 4)])
def test_qmm_plan_splits_cover_k_once_in_whole_byte_rows(ratio, K, N):
    plan = tqk.qmm_plan(8, K, N, ratio)
    rows = K // ratio
    ranges = _split_rows(plan, rows)
    assert plan.cols_per_cta == tqk.THIN_COLS
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)                 # none empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.rows_per_split * ratio <= tqk.THIN_KCAP      # fits x's stage


@pytest.mark.parametrize("container", ["int8", "int4x2", "int2x4"])
def test_qmm_plan_split_sums_match_the_plain_version(container):
    """Summing the per-split products in split order, scale at emit, as the
    thin-M kernel and its second pass do, gives the plain version's output:
    a gap or an overlap between splits would not."""
    ratio = {"int8": 1, "int4x2": 2, "int2x4": 4}[container]
    qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
    rng = np.random.default_rng(3)
    M, K, N = 3, 512, 96
    codes = _t(rng.integers(-qm, qm + 1, size=(K, N)).astype(np.int8))
    scales = _t((rng.random(N) / (qm * 4)).astype(np.float32))
    x = _t(rng.normal(size=(M, K)).astype(np.float32))
    plan = tqk.qmm_plan(M, K, N, ratio)
    assert plan.k_splits > 1
    acc = torch.zeros((M, N))
    for lo, hi in _split_rows(plan, K // ratio):
        ks = slice(lo * ratio, hi * ratio)
        acc = acc + x[:, ks] @ codes[ks].float()
    ref = quant_matmul_ref(x, codes, scales)
    torch.testing.assert_close(acc * scales, ref, **TOL)


def test_llama_decode_leaves_fill_the_card_on_the_thin_m_route():
    """llama3.2-1b's quant leaves at decode (8 slots, int4x2): wq / wo
    (2048 x 2048) and wk / wv (2048 x 512) each launch >= 2 x 132 CTAs."""
    cfg = t_get_config("llama3.2-1b")
    D, qd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    for K, N in ((D, qd), (D, kvd), (D, kvd), (qd, D)):
        for M in (1, 8, 16):
            plan = tqk.qmm_plan(M, K, N, 2)
            assert plan is not None
            assert -(-N // plan.cols_per_cta) * plan.k_splits >= 264, (K, N)


@pytest.mark.parametrize("M,N,w_ptr,route", [
    (1, 2048, 0, "thin_m"), (16, 512, 256, "thin_m"), (8, 96, 4, "thin_m"),
    (17, 2048, 0, "tiled"), (128, 2048, 0, "tiled"), (512, 2048, 0, "tiled"),
    (8, 90, 0, "tiled"), (8, 2048, 2, "tiled"),
])
def test_qmm_route_rule(M, N, w_ptr, route):
    plan = tqk.qmm_plan(M, 2048, N, 2, w_ptr)
    assert ("tiled" if plan is None else "thin_m") == route


def test_build_paths_are_ignored_and_not_touched_at_import():
    root = build.BUILD_ROOT.parents[1]
    assert (root / ".gitignore").read_text().splitlines().count("build/") == 1
    assert build.build_dir().parent == build.BUILD_ROOT
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert build._digest() == build._digest()


# ------------------------------------------------------------------ on card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    for container in ("f32", "int8", "int4x2", "int2x4"):
        x, vals, scales, bias, rows, cols, nR, nC = _sparse_case(
            container, seed=1, bk=32, bn=64)
        blocks, packed = _t(vals), False
        if container in ("int4x2", "int2x4"):
            packed = container
            blocks = pack_codes(blocks, axis=1,
                                bits=4 if container == "int4x2" else 2)
        s = None if scales is None else _t(scales).to(dev)
        sched = tsk.make_schedule(rows, cols, nR, nC, dev)
        y = tsk.block_sparse_matmul(_t(x).to(dev), blocks.to(dev), sched,
                                    scales=s, bias=_t(bias).to(dev),
                                    activation="silu", packed=packed)
        ref = block_sparse_matmul_ref(_t(x), _t(vals), rows, cols,
                                      n_row_blocks=nR, n_col_blocks=nC,
                                      scales=None if s is None else s.cpu(),
                                      bias=_t(bias), activation="silu")
        np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
    q, k_p, v_p, k_s, v_s = _attn_case(2, 3, 100, 8, 2, 64, seed=2)
    lengths = _t(np.array([[1, 2, 3], [98, 99, 100]], np.int32))
    cpu = [_t(a) for a in (q, k_p, v_p, k_s, v_s)]
    y = tdp.packed_decode_attention(*(a.to(dev) for a in cpu),
                                    lengths.to(dev), bt=64)
    ref = tdp.tiled_packed_attention(*cpu, lengths, bt=64)
    np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
