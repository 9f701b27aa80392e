"""The register-tiled route of the port's fused convs (``block_sparse_conv``
and ``quant_conv``), held on the CPU: ``conv_route`` case by case and at
LeNet's shapes, each plan's ownership of outputs and of the K walk
replayed from ``ConvPlan``, and the route's arithmetic order replayed in
plain PyTorch against ``repro``'s Pallas kernels in interpret mode on
identical numpy inputs.

The kernels run only on a card (``chip_smoke.py`` and the ``gpu`` test of
``tests/test_torch_conv.py``).  Their order, as replayed here: per output
position and column, f32 FMAs over the K part's walk steps in order (quant:
k rows; block-sparse: the column block's present blocks in row order, each
weight scaled before the dot), the parts' sums added in part order, then
(quant) times the scale, plus bias, the activation, and the 2 x 2 pool
(avg: ((a + b) + c) + d, then / 4).  Tolerance: f32 ``rtol=1e-5,
atol=1e-6``, as in ``tests/test_torch_conv.py``: only the order of
summation differs, on outputs of size O(1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant_matmul.kernel import quant_conv as j_qconv  # noqa: E402
from repro.kernels.sparse_matmul.kernel import block_sparse_conv as j_bsc  # noqa: E402
from repro_torch.core.quant import pack_codes  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
F32 = torch.float32

# LeNet-5's convs on 28 x 28 digits (models/lenet.py): (H, W, C), kernel,
# (bk, bn) of the Table-I block pattern, N; both pool 2 x 2 at emit
LENET = {"conv1": ((28, 28, 1), (5, 5), (5, 2), 6),
         "conv2": ((12, 12, 6), (5, 5), (10, 4), 16)}
AVG2 = ("avg", 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _route(kind, B, hwc, khw, pool, N, block=None, max_col=0, strides=(1, 1),
           dilation=(1, 1), dtype=F32):
    if kind == "quant":
        block, max_col = None, 0
    return tsk.conv_route(B, *hwc, khw, strides, dilation, pool, N, dtype,
                          block=block, max_blocks_per_col=max_col)


# --------------------------------------------------------------- the rule


# (layer, kind, max blocks per column, ct, img, ks, CTAs)
@pytest.mark.parametrize("layer,kind,max_col,ct,img,ks,ctas", [
    ("conv1", "quant", 0, 4, 1, 1, 512),
    ("conv1", "sparse", 4, 2, 1, 1, 768),
    ("conv2", "quant", 0, 4, 2, 5, 512),
    ("conv2", "sparse", 10, 4, 2, 5, 512),
])
def test_lenet_convs_take_reg_tile_and_fill_the_card(layer, kind, max_col, ct,
                                                     img, ks, ctas):
    """At B = 256 both LeNet convs, under both policies, take the register
    tile with at least one wave of 132 CTAs and several warps an SM."""
    hwc, khw, block, N = LENET[layer]
    route, plan = _route(kind, 256, hwc, khw, AVG2, N, block, max_col)
    assert route == "reg_tile"
    assert (plan.ct, plan.img, plan.ks) == (ct, img, ks)
    n_ctas = plan.grid[0] * plan.grid[1]
    assert n_ctas == ctas and n_ctas >= tsk.REG_SMS
    assert n_ctas * plan.threads // 32 >= 16 * tsk.REG_SMS  # warps
    assert plan.threads <= tsk.REG_MAX_THREADS and plan.part % 32 == 0
    assert plan.smem <= tsk.REG_SMEM_MAX


# (case, kind, B, hwc, khw, strides, dilation, pool, N, block, dtype, route)
RULE_CASES = [
    ("lenet conv2, one image", "quant", 1, (12, 12, 6), (5, 5), (1, 1),
     (1, 1), AVG2, 16, None, F32, "reg_tile"),
    ("lenet conv2 bf16", "sparse", 256, (12, 12, 6), (5, 5), (1, 1), (1, 1),
     AVG2, 16, (10, 4), torch.bfloat16, "reg_tile"),
    ("strided, no pool", "quant", 256, (11, 11, 4), (3, 3), (2, 2), (1, 1),
     None, 8, None, F32, "reg_tile"),
    ("strided, no pool", "sparse", 7, (11, 11, 4), (3, 3), (2, 2), (1, 1),
     None, 8, (12, 4), F32, "reg_tile"),
    ("dilated, 3x3 max pool", "quant", 256, (13, 13, 4), (3, 3), (1, 1),
     (2, 2), ("max", 3), 8, None, F32, "band"),
    ("lenet conv1, 3x3 max pool", "sparse", 256, (28, 28, 1), (5, 5),
     (1, 1), (1, 1), ("max", 3), 6, (5, 2), F32, "band"),
    ("N past the largest tile", "quant", 256, (12, 12, 6), (5, 5), (1, 1),
     (1, 1), AVG2, 20, None, F32, "reg_tile"),
    ("bn past the largest tile", "sparse", 256, (12, 12, 6), (5, 5), (1, 1),
     (1, 1), ("max", 2), 32, (10, 16), F32, "reg_tile"),
    ("odd bn", "sparse", 256, (12, 12, 6), (5, 5), (1, 1), (1, 1), AVG2, 15,
     (10, 3), F32, "band"),
    ("a 224x224 image", "quant", 8, (224, 224, 3), (3, 3), (1, 1), (1, 1),
     AVG2, 16, None, F32, "band"),
    ("f16 x", "quant", 256, (12, 12, 6), (5, 5), (1, 1), (1, 1), AVG2, 16,
     None, torch.float16, "band"),
]


@pytest.mark.parametrize("case,kind,B,hwc,khw,strides,dilation,pool,N,block,"
                         "dtype,route", RULE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in RULE_CASES])
def test_conv_route_rule(case, kind, B, hwc, khw, strides, dilation, pool, N,
                         block, dtype, route):
    got, plan = _route(kind, B, hwc, khw, pool, N, block, 3, strides,
                       dilation, dtype)
    assert got == route
    assert (plan is None) == (route == "band")
    if plan is None:
        return
    assert plan.ct in tsk.REG_TILES
    if block is None:
        assert plan.n_ct == -(-N // plan.ct)
    else:
        assert block[1] % plan.ct == 0 and plan.n_ct == N // plan.ct
    n_ctas = plan.grid[0] * plan.grid[1]
    # below one wave only because the batch has too few images
    assert n_ctas >= tsk.REG_SMS or plan.img == 1
    assert plan.threads <= tsk.REG_MAX_THREADS


@pytest.mark.parametrize("B", [1, 7, 256])
@pytest.mark.parametrize("geom", [
    ((28, 28, 1), (5, 5), (1, 1), (1, 1), AVG2, 6, (5, 2)),
    ((12, 12, 6), (5, 5), (1, 1), (1, 1), ("max", 2), 16, (10, 4)),
    ((11, 11, 4), (3, 3), (2, 2), (1, 1), None, 8, (12, 4)),
    ((13, 13, 4), (3, 3), (1, 1), (2, 2), ("max", 3), 8, (12, 4)),
])
def test_the_two_wrappers_agree_on_the_rule(B, geom):
    """Both convs take their route from the same rule: at a geometry both
    kernels take (even bn), they take the same route."""
    hwc, khw, st, dl, pool, N, block = geom
    q, _ = _route("quant", B, hwc, khw, pool, N, strides=st, dilation=dl)
    s, _ = _route("sparse", B, hwc, khw, pool, N, block, 2, st, dl)
    assert q == s


def test_cpu_calls_count_no_conv_route():
    """On the CPU the wrappers take their plain versions: no conv route's
    counter moves."""
    for mod in (tsk, tqk):
        mod.conv_launches = mod.conv_launches_reg = 0
        mod.conv_launches_band = 0
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(2, 12, 12, 6)).astype(np.float32))
    codes = rng.integers(-7, 8, size=(150, 16)).astype(np.int8)
    tqk.quant_conv(x, _t(codes), torch.ones(16), kernel_hw=(5, 5), pool=AVG2)
    sched = tsk.make_schedule(np.array([0, 3]), np.array([0, 2]), 15, 4,
                              "cpu")
    tsk.block_sparse_conv(x, _t(codes[:20].reshape(2, 10, 16)[..., :4]),
                          sched, kernel_hw=(5, 5), pool=AVG2)
    for mod in (tsk, tqk):
        assert (mod.conv_launches, mod.conv_launches_reg,
                mod.conv_launches_band) == (0, 0, 0)


# ---------------------------------------------------- ownership, replayed


def _owners(plan, B, Ho, Wo, N, walk_of_tile):
    """Replay the kernel's index arithmetic (csrc/conv_reg.cuh
    reg_conv_tail) over every CTA, thread and register slot.

    Returns {(image, out row, out col, column): [emitter]} for the
    emitting threads (part 0), and {(image, column tile): [steps walked,
    in order, part after part]}; ``walk_of_tile(by)`` is the tile's walk
    length in steps (quant: K; block-sparse: its column block's blocks x
    bk), ``unit`` steps per walk unit of ``plan.per``."""
    walk, unit = walk_of_tile
    outs, steps = {}, {}
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            total = walk(by)
            n0 = by * plan.ct        # quant tiles and block-sparse slices
            for t in range(plan.threads):
                kp, u = divmod(t, plan.part)
                ii, un = divmod(u, plan.units)
                b = bx * plan.img + ii
                if ii >= plan.img or b >= B:
                    continue
                s0 = min(total, kp * plan.per * unit)
                s1 = min(total, (kp + 1) * plan.per * unit)
                steps.setdefault((b, by, un), []).extend(range(s0, s1))
                if kp:
                    continue
                ur, uc = divmod(un, plan.upr)
                if plan.z == 2:
                    pos = [(ur, uc)]
                else:
                    pos = [(ur, tsk.REG_STRIP * uc + p)
                           for p in range(tsk.REG_POS)
                           if tsk.REG_STRIP * uc + p < Wo]
                for (r, c) in pos:
                    for j in range(plan.ct):
                        if n0 + j < N:
                            outs.setdefault((b, r, c, n0 + j), []).append(
                                (bx, by, t, j))
    return outs, steps


OWNER_CASES = [
    ("quant", 256, (28, 28, 1), (5, 5), (1, 1), AVG2, 6, None),
    ("quant", 256, (12, 12, 6), (5, 5), (1, 1), AVG2, 16, None),
    ("quant", 7, (12, 12, 6), (5, 5), (1, 1), ("max", 2), 20, None),
    ("quant", 5, (11, 11, 4), (3, 3), (2, 2), None, 8, None),
    ("sparse", 256, (28, 28, 1), (5, 5), (1, 1), AVG2, 6, (5, 2)),
    ("sparse", 256, (12, 12, 6), (5, 5), (1, 1), AVG2, 16, (10, 4)),
    ("sparse", 3, (12, 12, 6), (5, 5), (1, 1), AVG2, 32, (10, 16)),
    ("sparse", 9, (11, 11, 4), (3, 3), (2, 2), None, 8, (12, 4)),
]


@pytest.mark.parametrize("kind,B,hwc,khw,strides,pool,N,block", OWNER_CASES)
def test_every_output_has_one_owner_and_the_walk_is_covered_once(
        kind, B, hwc, khw, strides, pool, N, block):
    """Every (image, output position, column) is emitted by exactly one
    (CTA, thread, register slot); each thread unit's K parts walk every
    step of its tile once, in order; for block-sparse, every present block
    of the tile's column block once, in row order."""
    H, W, C = hwc
    K = C * khw[0] * khw[1]
    Ho, Wo = tsk.valid_out_hw(H, W, khw, strides, (1, 1))
    z = 1 if pool is None else pool[1]
    if block is None:
        route, plan = _route(kind, B, hwc, khw, pool, N, strides=strides)
        walk_of_tile, sched = (lambda by: K, 1), None
    else:
        bk, bn = block
        rng = np.random.default_rng(B)
        bitmap = rng.random((K // bk, N // bn)) < 0.5
        bitmap[:, -1] = False                     # an absent column block
        bitmap[0, 0] = True
        sched = tsk.make_schedule(*np.nonzero(bitmap), *bitmap.shape, "cpu")
        route, plan = _route(kind, B, hwc, khw, pool, N, block,
                             sched.max_blocks_per_col, strides)
        counts = sched.col_counts
        n_sub = bn // plan.ct
        walk_of_tile = (lambda by: int(counts[by // n_sub]) * bk, bk)
    assert route == "reg_tile" and plan.z == z
    outs, steps = _owners(plan, B, Ho, Wo, N, walk_of_tile)
    want = {(b, r, c, n) for b in range(B) for r in range(Ho // z)
            for c in range(Wo // z) for n in range(N)}
    assert set(outs) == want
    assert all(len(v) == 1 for v in outs.values())
    for (b, by, un), walked in steps.items():
        assert walked == list(range(walk_of_tile[0](by)))
    if sched is not None:
        # the tile's walk is its column block's schedule entries in order,
        # whose rows rise: each present block once, in row order
        col_ptr, rows = sched.col_ptr.numpy(), sched.rows.numpy()
        for c in range(sched.n_col_blocks):
            r = rows[col_ptr[c]:col_ptr[c + 1]]
            assert list(r) == sorted(r)
            assert set(r) == set(np.nonzero(bitmap[:, c])[0])


# ----------------------------------------------------- the arithmetic order


def _patches(x, khw, strides=(1, 1)):
    return tsk.im2col_valid(x, khw, strides)      # (B, Ho, Wo, K) f32


def _part_sums(patches, w_rows, plan, unit, total):
    """Per part, f32 FMAs over its walk steps in order (torch's mul-add
    rounds twice where the kernel's FMA rounds once: within TOL); the parts
    added in part order.  ``w_rows[s]``: step s's (k, weight row)."""
    acc = None
    for kp in range(plan.ks):
        s0 = min(total, kp * plan.per * unit)
        s1 = min(total, (kp + 1) * plan.per * unit)
        part = torch.zeros(patches.shape[:3] + (w_rows[0][1].numel(),))
        for s in range(s0, s1):
            k, row = w_rows[s]
            part = part + patches[..., k:k + 1] * row
        acc = part if acc is None else acc + part
    return acc


def _emit(acc, bias, act, pool):
    y = acc if bias is None else acc + bias
    y = tsk.apply_activation(y, act)
    if pool is None:
        return y
    a, b = y[:, 0::2, 0::2], y[:, 0::2, 1::2]
    c, d = y[:, 1::2, 0::2], y[:, 1::2, 1::2]
    if pool[0] == "max":
        return torch.maximum(torch.maximum(torch.maximum(a, b), c), d)
    return (((a + b) + c) + d) / 4.0


@pytest.mark.parametrize("layer,container,pool,act", [
    ("conv1", "int8", AVG2, "relu"),
    ("conv2", "int4x2", AVG2, "relu"),
    ("conv2", "int8", ("max", 2), ("trelu", 0.1)),
])
def test_quant_reg_order_matches_the_reference(layer, container, pool, act):
    (H, W, C), khw, _, N = LENET[layer]
    B = 2
    K = C * khw[0] * khw[1]
    rng = np.random.default_rng(len(layer) + len(container))
    qm = 127 if container == "int8" else 7
    codes = rng.integers(-qm, qm + 1, size=(K, N)).astype(np.int8)
    scales = (rng.random(N) / (qm * 4)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    route, plan = _route("quant", B, (H, W, C), khw, pool, N)
    assert route == "reg_tile"
    if layer == "conv2":
        assert plan.ks > 1                # parts and the in-CTA reduce
    cod = _t(codes).float()
    y = torch.zeros((B, H - khw[0] + 1, W - khw[1] + 1, N))
    p = _patches(_t(x), khw)
    for by in range(plan.n_ct):           # each column tile on its own
        cs = slice(by * plan.ct, min(N, (by + 1) * plan.ct))
        rows = [(k, cod[k, cs]) for k in range(K)]
        y[..., cs] = _part_sums(p, rows, plan, 1, K) * _t(scales[cs])
    got = _emit(y, _t(bias), act, pool)
    w_t = _t(codes)
    packed = False
    if container == "int4x2":
        packed, w_t = container, pack_codes(w_t, axis=0, bits=4)
    want = j_qconv(jnp.asarray(x), jnp.asarray(w_t.numpy()),
                   jnp.asarray(scales), jnp.asarray(bias), kernel_hw=khw,
                   activation=act, pool=pool, interpret=True, packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer,container,pool,act", [
    ("conv1", "int8", AVG2, "relu"),
    ("conv2", "int4x2", AVG2, "relu"),
    ("conv2", "f32", ("max", 2), None),
])
def test_block_sparse_reg_order_matches_the_reference(layer, container, pool,
                                                      act):
    """Each column block walks its present blocks in row order with the
    scale applied to each weight before the dot; a column block with no
    present block emits act(b)."""
    (H, W, C), khw, (bk, bn), N = LENET[layer]
    B = 2
    K = C * khw[0] * khw[1]
    nR, nC = K // bk, N // bn
    rng = np.random.default_rng(10 + len(layer) + len(container))
    bitmap = rng.random((nR, nC)) < 0.5
    bitmap[0, 0] = True
    bitmap[:, 1] = False                          # an absent column block
    brows, bcols = np.nonzero(bitmap)
    P = brows.size
    scales = None
    if container == "f32":
        vals = (rng.normal(size=(P, bk, bn)) / 4).astype(np.float32)
    else:
        qm = 127 if container == "int8" else 7
        vals = rng.integers(-qm, qm + 1, size=(P, bk, bn)).astype(np.int8)
        scales = (rng.random(N) / (qm * 4)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    sched = tsk.make_schedule(brows, bcols, nR, nC, "cpu")
    route, plan = _route("sparse", B, (H, W, C), khw, pool, N, (bk, bn),
                         sched.max_blocks_per_col)
    assert route == "reg_tile"
    if layer == "conv2":
        assert plan.ks > 1
    col_ptr, srows = sched.col_ptr.numpy(), sched.rows.numpy()
    pidx = sched.pidx.numpy()
    v = _t(vals).float()
    sc = torch.ones(N) if scales is None else _t(scales)
    y = torch.zeros((B, H - khw[0] + 1, W - khw[1] + 1, N))
    p = _patches(_t(x), khw)
    n_sub = bn // plan.ct
    for by in range(plan.n_ct):
        c, jb = divmod(by, n_sub)
        cs = slice(c * bn + jb * plan.ct, c * bn + (jb + 1) * plan.ct)
        rows = [(srows[q] * bk + kr, v[pidx[q], kr, jb * plan.ct:
                                      (jb + 1) * plan.ct] * sc[cs])
                for q in range(col_ptr[c], col_ptr[c + 1])
                for kr in range(bk)]
        if rows:
            y[..., cs] = _part_sums(p, rows, plan, bk, len(rows))
    got = _emit(y, _t(bias), act, pool)
    blocks, packed = _t(vals), False
    if container == "int4x2":
        packed, blocks = container, pack_codes(blocks, axis=1, bits=4)
    want = j_bsc(jnp.asarray(x), jnp.asarray(blocks.numpy()), brows, bcols,
                 kernel_hw=khw, n_row_blocks=nR, n_col_blocks=nC,
                 scales=None if scales is None else jnp.asarray(scales),
                 bias=jnp.asarray(bias), activation=act, pool=pool,
                 interpret=True, packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
