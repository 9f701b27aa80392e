"""The port's conv pieces vs the JAX reference on identical numpy inputs:
the geometry helpers (bitwise), the plain versions of the fused conv and
FC-stack kernels vs the Pallas kernels in interpret mode, ``compile_conv``
(byte-equal payloads) and ``conv_dispatch``.

On the CPU every wrapper takes its plain version and launches nothing; the
CUDA kernels are held against the plain versions by the ``gpu``-marked test
at the end (and by ``chip_smoke.py``) on a card.

Tolerance: f32 ``rtol=1e-5, atol=1e-6`` — only the order of summation
differs (the Pallas kernels sum block by block, the plain versions all K
at once), on outputs of size O(1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.kernels.fc_stack import fc_stack_matmul as j_fcs  # noqa: E402
from repro.kernels.quant_matmul.kernel import quant_conv as j_qconv  # noqa: E402
from repro.kernels.sparse_matmul.kernel import block_sparse_conv as j_bsc  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core.quant import pack_codes  # noqa: E402
from repro_torch.kernels import fc_stack as tfk  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.quant_matmul.ref import quant_conv_ref  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.kernels.sparse_matmul.ref import block_sparse_conv_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------- geometry

GEOMS = [(pad, s, d) for pad in ("VALID", "SAME") for s in (1, 2)
         for d in (1, 2)]


@pytest.mark.parametrize("padding,stride,dil", GEOMS)
def test_conv_geometry_bitwise_matches_reference(padding, stride, dil):
    rng = np.random.default_rng(stride * 10 + dil)
    x = rng.normal(size=(2, 9, 8, 3)).astype(np.float32)
    khw, strides, dilation = (3, 2), (stride, 1), (dil, dil)
    assert td.conv_out_hw((9, 8), khw, strides, padding, dilation) == \
        jd.conv_out_hw((9, 8), khw, strides, padding, dilation)
    kw = dict(strides=strides, padding=padding, dilation=dilation)
    np.testing.assert_array_equal(
        td.conv_pre_pad(_t(x), khw, **kw).numpy(),
        np.asarray(jd.conv_pre_pad(jnp.asarray(x), khw, **kw)))
    np.testing.assert_array_equal(
        td.conv_im2col(_t(x), khw, **kw).numpy(),
        np.asarray(jd.conv_im2col(jnp.asarray(x), khw, **kw)))


def test_conv_pre_pad_rejects_unknown_padding():
    with pytest.raises(ValueError, match="VALID' or 'SAME"):
        td.conv_pre_pad(torch.zeros((1, 4, 4, 1)), (2, 2), strides=(1, 1),
                        padding="CAUSAL")


# ------------------------------------------------------ block-sparse conv

# (container, pool, bias, activation, strides, dilation, empty)
BSC_CASES = [
    ("f32", None, True, "relu", (1, 1), (1, 1), False),
    ("f32", ("avg", 2), False, None, (1, 1), (1, 1), False),
    ("int8", ("max", 2), True, "relu", (1, 1), (1, 1), False),
    ("int8", None, False, None, (1, 2), (2, 1), False),
    ("int4x2", ("avg", 2), True, "relu", (1, 1), (1, 1), False),
    ("int4x2", ("max", 2), True, None, (2, 1), (1, 1), False),
    ("int2x4", ("avg", 2), True, "relu", (1, 1), (1, 1), False),
    ("int2x4", None, True, None, (1, 1), (2, 2), False),
    ("int8", ("avg", 2), True, "relu", (1, 1), (1, 1), True),
]


def _bsc_case(container, seed, empty, bk=8, bn=4, cin=4, khw=(2, 2),
              hw=(9, 9), B=2):
    """A random pattern over the (cin*kh*kw, 3*bn) im2col matrix with the
    middle column block absent."""
    rng = np.random.default_rng(seed)
    K = cin * khw[0] * khw[1]
    nR, nC = K // bk, 3
    bitmap = rng.random((nR, nC)) < 0.6
    bitmap[0, 0] = True
    bitmap[:, 1] = False
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
    x = rng.normal(size=(B,) + hw + (cin,)).astype(np.float32)
    bias = rng.normal(size=nC * bn).astype(np.float32)
    return x, vals, scales, bias, rows, cols, nR, nC


@pytest.mark.parametrize(
    "container,pool,with_bias,act,strides,dilation,empty", BSC_CASES)
def test_block_sparse_conv_plain_matches_pallas_interpret(
        container, pool, with_bias, act, strides, dilation, empty):
    x, vals, scales, bias, rows, cols, nR, nC = _bsc_case(
        container, seed=len(container) + strides[0], empty=empty)
    bias = bias if with_bias else None
    blocks_t, packed = _t(vals), False
    if container in ("int4x2", "int2x4"):
        packed = container
        blocks_t = pack_codes(blocks_t, axis=1,
                              bits=4 if container == "int4x2" else 2)
    kw = dict(kernel_hw=(2, 2), activation=act, strides=strides,
              dilation=dilation, pool=pool)
    want = j_bsc(jnp.asarray(x), jnp.asarray(_np(blocks_t)), rows, cols,
                 n_row_blocks=nR, n_col_blocks=nC,
                 scales=None if scales is None else jnp.asarray(scales),
                 bias=None if bias is None else jnp.asarray(bias),
                 interpret=True, packed=packed, **kw)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    tsk.conv_launches = 0
    got = tsk.block_sparse_conv(
        _t(x), blocks_t, sched, scales=None if scales is None else _t(scales),
        bias=None if bias is None else _t(bias), packed=packed, **kw)
    assert tsk.conv_launches == 0     # the CPU takes the plain version
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not empty:   # the plain version itself, on the unpacked codes
        ref = block_sparse_conv_ref(
            _t(x), _t(vals), rows, cols, n_row_blocks=nR, n_col_blocks=nC,
            scales=None if scales is None else _t(scales),
            bias=None if bias is None else _t(bias), **kw)
        np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_block_sparse_conv_rejects_bad_geometry():
    x, vals, scales, bias, rows, cols, nR, nC = _bsc_case("int8", 0, False)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    kw = dict(kernel_hw=(2, 2), scales=_t(scales))
    with pytest.raises(ValueError, match="does not tile"):
        tsk.block_sparse_conv(_t(x), _t(vals), sched, pool=("avg", 3), **kw)
    with pytest.raises(ValueError, match="unknown fused pool"):
        tsk.block_sparse_conv(_t(x), _t(vals), sched, pool=("min", 2), **kw)
    with pytest.raises(ValueError, match="im2col K"):
        tsk.block_sparse_conv(_t(x[..., :2]), _t(vals), sched, **kw)
    with pytest.raises(ValueError, match="does not fit"):
        tsk.block_sparse_conv(_t(x[:, :1, :1]), _t(vals), sched, **kw)


# -------------------------------------------------------------- quant conv

# (container, pool, bias, activation, strides, dilation)
QCONV_CASES = [
    ("int8", None, True, "relu", (1, 1), (1, 1)),
    ("int8", ("avg", 2), False, None, (1, 1), (1, 1)),
    ("int8", ("max", 2), True, "relu", (2, 1), (1, 1)),
    ("int4x2", ("avg", 2), True, "relu", (1, 1), (1, 1)),
    ("int4x2", None, False, None, (1, 2), (2, 1)),
]


@pytest.mark.parametrize("container,pool,with_bias,act,strides,dilation",
                         QCONV_CASES)
def test_quant_conv_plain_matches_pallas_interpret(
        container, pool, with_bias, act, strides, dilation):
    rng = np.random.default_rng(len(container) + strides[0])
    cin, khw, N = 3, (2, 2), 5
    K = cin * khw[0] * khw[1]
    qm = 127 if container == "int8" else 7
    codes = rng.integers(-qm, qm + 1, size=(K, N)).astype(np.int8)
    scales = (rng.random(N) / (qm * 4)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32) if with_bias else None
    x = rng.normal(size=(2, 9, 9, cin)).astype(np.float32)
    w_t, packed = _t(codes), False
    if container == "int4x2":
        packed = container
        w_t = pack_codes(w_t, axis=0, bits=4)
    kw = dict(kernel_hw=khw, activation=act, strides=strides,
              dilation=dilation, pool=pool)
    want = j_qconv(jnp.asarray(x), jnp.asarray(_np(w_t)), jnp.asarray(scales),
                   None if bias is None else jnp.asarray(bias),
                   interpret=True, packed=packed, **kw)
    tqk.conv_launches = 0
    got = tqk.quant_conv(_t(x), w_t, _t(scales),
                         None if bias is None else _t(bias), packed=packed,
                         **kw)
    assert tqk.conv_launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = quant_conv_ref(_t(x), _t(codes), _t(scales),
                         None if bias is None else _t(bias), **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_quant_conv_rejects_odd_k_in_a_packed_container():
    x = torch.zeros((1, 6, 6, 1))
    with pytest.raises(ValueError, match="K divisible"):
        tqk.quant_conv(x, torch.zeros((13, 4), dtype=torch.uint8),
                       torch.ones(4), kernel_hw=(5, 5), packed="int4x2")


# ----------------------------------------------------------------- fc stack


@pytest.mark.parametrize("acts", [("relu", "relu", None),
                                  ("silu", None, ("trelu", 0.1))])
def test_fc_stack_plain_matches_pallas_interpret(acts):
    rng = np.random.default_rng(len(str(acts)))
    dims = [16, 12, 8, 5]
    x = rng.normal(size=(3, dims[0])).astype(np.float32)
    ws = [rng.normal(size=(k, n)).astype(np.float32) / np.sqrt(k)
          for k, n in zip(dims, dims[1:])]
    bs = [rng.normal(size=n).astype(np.float32) for n in dims[1:]]
    bs[1] = None
    want = j_fcs(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                 [None if b is None else jnp.asarray(b) for b in bs],
                 list(acts), bm=8, interpret=True)
    tfk.launches = 0
    got = tfk.fc_stack_matmul(_t(x), [_t(w) for w in ws],
                              [None if b is None else _t(b) for b in bs],
                              list(acts))
    assert tfk.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tfk.fc_stack_matmul_ref(_t(x), [_t(w) for w in ws],
                                [None if b is None else _t(b) for b in bs],
                                list(acts)).numpy(), np.asarray(want), **TOL)


def test_fc_stack_rejects_a_broken_chain():
    w = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="chain mismatch"):
        tfk.fc_stack_matmul(torch.zeros((2, 4)), [w, w], [None, None],
                            [None, None])
    with pytest.raises(ValueError, match="feature dim"):
        tfk.fc_stack_matmul(torch.zeros((2, 5)), [w], [None], [None])


# ---------------------------------------------- compile_conv + conv_dispatch

# (policy, bits, strides, padding, dilation, pool)
CONV_DISPATCH = [
    ("sparse", 4, (1, 1), "VALID", (1, 1), ("avg", 2)),
    ("sparse", 8, (2, 2), "SAME", (1, 1), None),
    ("quant", 4, (1, 1), "SAME", (2, 2), ("max", 2)),
    ("quant", 8, (1, 2), "VALID", (1, 1), None),
    ("dense", 8, (1, 1), "SAME", (1, 1), ("avg", 2)),
]


def _conv_both(policy, bits, strides, padding, dilation, masked):
    rng = np.random.default_rng(bits + len(policy))
    w4 = (rng.normal(size=(3, 3, 4, 8)) / 6).astype(np.float32)
    mask = rng.random((3, 3, 4, 8)) < 0.5 if masked else None
    kw = dict(strides=strides, padding=padding, dilation=dilation, mask=mask,
              policy=policy, in_hw=(10, 10))
    rules = dict(block=(12, 4), quant_bits=bits, min_weight_elems=0)
    jcp, jpat, jrep = jc.compile_conv(w4, rules=jc.CompileRules(**rules),
                                      **kw)
    tcp, tpat, trep = tc.compile_conv(
        w4, rules=tc.CompileRules(**rules, dtype=torch.float32),
        device="cpu", **kw)
    return w4, (jcp, jpat, jrep), (tcp, tpat, trep)


@pytest.mark.parametrize("policy,bits,strides,padding,dilation,pool",
                         CONV_DISPATCH)
def test_compile_conv_and_conv_dispatch_match_reference(
        policy, bits, strides, padding, dilation, pool):
    _, (jcp, jpat, jrep), (tcp, tpat, trep) = _conv_both(
        policy, bits, strides, padding, dilation, masked=policy == "dense")
    assert (tcp.kernel, tcp.strides, tcp.padding, tcp.dilation) == \
        (jcp.kernel, jcp.strides, jcp.padding, jcp.dilation)
    assert td.payload_registry.family_of_payload(tcp.payload).name == \
        jd.payload_registry.family_of_payload(jcp.payload).name
    np.testing.assert_array_equal(
        _np(td._payload_dense_f32(tcp.payload, "cpu")),
        np.asarray(jd._payload_dense_f32(jcp.payload)))
    assert (jpat is None) == (tpat is None)
    if jpat is not None:
        np.testing.assert_array_equal(tpat.bitmap, jpat.bitmap)
    assert trep == tc.LayerReport(**{k: getattr(jrep, k)
                                     for k in trep.__dataclass_fields__})
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 10, 4)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    if pool is not None and td.conv_out_hw((10, 10), (3, 3), strides,
                                           padding, dilation)[0] % pool[1]:
        pool = None
    kw = dict(bias=None, activation="relu", pool=pool)
    want = jd.conv_dispatch(jcp, jnp.asarray(x), dispatch="jnp",
                            **{**kw, "bias": jnp.asarray(b)})
    for mode in ("auto", "twin"):
        got = td.conv_dispatch(tcp, _t(x), dispatch=mode,
                               **{**kw, "bias": _t(b)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_dispatch_takes_the_fused_entry_only_where_the_reference_does():
    _, _, (tcp, _, _) = _conv_both("sparse", 4, (1, 1), "VALID", (1, 1),
                                   masked=False)
    x = _t(np.ones((1, 10, 10, 4), np.float32))
    cfg = td.resolve("auto")
    # Ho = 8: a 2x2 window tiles the output, a 3x3 window does not
    assert td._conv_fused(tcp, x, cfg, None, None, None, "c",
                          ("avg", 2)) is not None
    assert td._conv_fused(tcp, x, cfg, None, None, None, "c",
                          ("avg", 3)) is None
    assert td._conv_fused(tcp, x, td.resolve("twin"), None, None, None, "c",
                          None) is None
    y = td.conv_dispatch(tcp, x, pool=("max", 3))     # the im2col leg
    assert tuple(y.shape) == (1, 2, 2, 8)


def test_conv_dispatch_rejects_mismatches_loudly():
    _, _, (tcp, _, _) = _conv_both("quant", 8, (1, 1), "VALID", (1, 1),
                                   masked=False)
    x = torch.zeros((1, 10, 10, 4))
    with pytest.raises(ValueError, match="strides"):
        td.conv_dispatch(tcp, x, strides=(2, 2))
    with pytest.raises(ValueError, match="padding"):
        td.conv_dispatch(tcp, x, padding="SAME")
    with pytest.raises(ValueError, match="dilation"):
        td.conv_dispatch(tcp, x, dilation=(2, 2))
    with pytest.raises(ValueError, match="trailing channel dim 4"):
        td.conv_dispatch(tcp, torch.zeros((1, 10, 10, 3)))
    with pytest.raises(ValueError, match="unknown conv pool"):
        td.conv_dispatch(tcp, x, pool=("sum", 2))
    with pytest.raises(TypeError, match="needs a ConvPayload"):
        td.conv_dispatch(tcp.payload, x)
    with pytest.raises(TypeError, match="conv_dispatch"):
        td.payload_dispatch(tcp, torch.zeros((2, 36)))
    with pytest.raises(ValueError, match="'kernel'"):
        td.conv_dispatch(tcp, x, dispatch="kernel")


def test_densified_payload_is_built_once_per_device():
    _, _, (tcp, _, _) = _conv_both("quant", 4, (1, 1), "VALID", (1, 1),
                                   masked=False)
    a = td._payload_dense_f32(tcp.payload, "cpu")
    assert td._payload_dense_f32(tcp.payload, "cpu") is a
    assert td._payload_kn(tcp.payload) == (36, 8)


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _both_routes(mod, call, launch, ref):
    """The wrapper ``call()`` takes the register-tiled route (its counter
    moves by one, the band one not); ``launch(route)`` runs each route
    uncounted; all three agree with the plain version ``ref``."""
    before = (mod.conv_launches_reg, mod.conv_launches_band)
    outs = [call()]
    assert (mod.conv_launches_reg - before[0],
            mod.conv_launches_band - before[1]) == (1, 0)
    outs += [launch("reg_tile"), launch("band")]
    for y in outs:
        np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.gpu
def test_cuda_conv_and_fc_stack_kernels_match_plain_versions(cuda_device):
    """Each conv case on the route ``conv_route`` names (the register
    tile) and, uncounted, on both routes: first at the test's own
    geometry, then at LeNet conv2's (12 x 12 x 6, 5 x 5, blocks of
    (10, 4)) with B = 256.  Then LeNet's FC stack at 7 and 256 rows on
    the route ``fcs_route`` names (staged) and, uncounted, on both."""
    dev = cuda_device
    for container, pool, lenet in (("int8", ("avg", 2), False),
                                   ("int4x2", ("max", 2), False),
                                   ("f32", None, False),
                                   ("int4x2", ("avg", 2), True)):
        shape = dict(bk=10, bn=4, cin=6, khw=(5, 5), hw=(12, 12), B=256) \
            if lenet else {}
        x, vals, scales, bias, rows, cols, nR, nC = _bsc_case(
            container, 1, False, **shape)
        khw = (5, 5) if lenet else (2, 2)
        blocks, packed = _t(vals), False
        if container == "int4x2":
            packed, blocks = container, pack_codes(blocks, axis=1, bits=4)
        s = None if scales is None else _t(scales)
        kw = dict(kernel_hw=khw, activation="relu", pool=pool)
        sched = tsk.make_schedule(rows, cols, nR, nC, dev)
        xd, bd = _t(x).to(dev), blocks.to(dev)
        sd, bid = None if s is None else s.to(dev), _t(bias).to(dev)
        bk, bn = blocks.shape[1] * tsk.packed_ratio(packed), blocks.shape[2]
        route, plan = tsk.conv_route(
            *x.shape, khw, (1, 1), (1, 1), pool, nC * bn, torch.float32,
            block=(bk, bn), max_blocks_per_col=sched.max_blocks_per_col)
        assert route == "reg_tile"
        ref = block_sparse_conv_ref(_t(x), _t(vals), rows, cols,
                                    n_row_blocks=nR, n_col_blocks=nC,
                                    scales=s, bias=_t(bias), **kw)
        _both_routes(
            tsk, lambda: tsk.block_sparse_conv(
                xd, bd, sched, scales=sd, bias=bid, packed=packed, **kw),
            lambda r: tsk._conv_launch(
                xd, bd, sched, khw, sd, bid, "relu", (1, 1), (1, 1), pool,
                tsk.packed_ratio(packed), r, plan), ref)
    rng = np.random.default_rng(3)
    for B, hw, cin, khw, K, N in ((3, 9, 4, (2, 2), 16, 5),
                                  (256, 12, 6, (5, 5), 150, 16)):
        codes = rng.integers(-7, 8, size=(K, N)).astype(np.int8)
        sc = (rng.random(N) / 28).astype(np.float32)
        x = rng.normal(size=(B, hw, hw, cin)).astype(np.float32)
        kw = dict(kernel_hw=khw, activation="relu", pool=("avg", 2))
        xd, sd = _t(x).to(dev), _t(sc).to(dev)
        wd = pack_codes(_t(codes), axis=0, bits=4).to(dev)
        route, plan = tsk.conv_route(B, hw, hw, cin, khw, (1, 1), (1, 1),
                                     ("avg", 2), N, torch.float32)
        assert route == "reg_tile"
        ref = quant_conv_ref(_t(x), _t(codes), _t(sc), **kw)
        _both_routes(
            tqk, lambda: tqk.quant_conv(xd, wd, sd, packed="int4x2", **kw),
            lambda r: tqk._conv_launch(xd, wd, sd, None, khw, "relu", (1, 1),
                                       (1, 1), ("avg", 2), 2, r, plan), ref)
    ws = [_t(rng.normal(size=(k, n)).astype(np.float32) / 8)
          for k, n in ((256, 120), (120, 84), (84, 10))]
    acts = ["relu", "relu", None]
    wd = [w.to(dev) for w in ws]
    for B in (7, 256):   # 4 and 128 CTAs of 2 rows (fcs_route)
        xf = _t(rng.normal(size=(B, 256)).astype(np.float32))
        xd = xf.to(dev)
        route, plan = tfk.fcs_route(B, [256, 120, 84, 10], torch.float32)
        assert route == "staged"
        before = (tfk.launches_staged, tfk.launches_stream)
        outs = [tfk.fc_stack_matmul(xd, wd, [None] * 3, acts)]
        assert (tfk.launches_staged - before[0],
                tfk.launches_stream - before[1]) == (1, 0)
        outs += [tfk._launch(xd, wd, [None] * 3, acts, r, plan)
                 for r in ("staged", "stream")]
        ref = tfk.fc_stack_matmul_ref(xf, ws, [None] * 3, acts)
        for y in outs:
            np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-5)
