"""The tensor-core routes of the port's matmuls (M > 16), held on the CPU:
``qmm_route`` / ``bsm_route`` case by case, the plans' coverage of K and of
each column's blocks and their grids at llama3.2-1b's compiled-forward
shapes, and the routes' arithmetic replayed in plain PyTorch against
``repro``'s jnp oracles on identical numpy inputs.

The kernels run only on a card (``chip_smoke.py``).  Their arithmetic, as
replayed here: each code decoded to bf16 by the kernels' exponent trick
(exact: an integer of at most 8 bits), bf16 x times bf16 codes accumulated
in f32 over each K split or range of blocks, the per-column scale applied
at emit (the reference scales each block before the dot), partials added
(here in split / range order; the reduce pass's fixed order differs only
in f32 rounding), then bias and activation, rounded to bf16.
Tolerance: one bf16 step of the reference output (the rounding of the
result) plus ``1e-6`` of its largest magnitude (the f32 sum order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant_matmul.ref import quant_matmul_ref as j_qmm_ref  # noqa: E402
from repro.kernels.sparse_matmul.ref import block_sparse_matmul_ref as j_bsm_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.quant import pack_codes  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402

QMAX = {"int8": 127, "int4x2": 7, "int2x4": 1}
RATIO = {"int8": 1, "int4x2": 2, "int2x4": 4}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- the rules


@pytest.mark.parametrize("M,K,N,x_bf16,w_ptr,x_ptr,route", [
    (16, 2048, 2048, True, 0, 0, "thin_m"),       # decode rows
    (17, 2048, 2048, True, 0, 0, "tensor_core"),  # first row past thin-M
    (512, 2048, 512, True, 256, 4096, "tensor_core"),
    (17, 2048, 2048, False, 0, 0, "tiled"),       # f32 x
    (512, 2080, 2048, True, 0, 0, "tiled"),       # K not whole 64-code steps
    (512, 2048, 320, True, 0, 0, "tensor_core"),  # a ragged last column tile
    (1088, 3072, 32064, True, 0, 0, "tensor_core"),  # phi-3-vision's head
    (24, 1024, 48, True, 0, 0, "tensor_core"),    # one ragged column tile
    (4096, 1280, 504, True, 0, 0, "tensor_core"),  # hubert's head: codes
    (512, 2048, 328, True, 0, 0, "tensor_core"),  # by cp.async (N % 16 == 8)
    (512, 2048, 2048, True, 4, 0, "tiled"),       # codes not 16-byte aligned
    (512, 2048, 2048, True, 0, 8, "tiled"),       # x not 16-byte aligned
    (512, 2048, 328, True, 8, 0, "tensor_core"),  # N % 16 == 8: 8-byte codes
    (512, 2048, 328, True, 4, 0, "tiled"),        # codes not 8-byte aligned
    (512, 2048, 504, True, 0, 8, "tiled"),        # x not 16-byte aligned
    (512, 2048, 324, True, 0, 0, "tiled"),        # N % 8 != 0
    (40, 1024, 40, True, 0, 0, "tensor_core"),    # one ragged tile, N 40
])
def test_qmm_route_rule(M, K, N, x_bf16, w_ptr, x_ptr, route):
    got, plan = tqk.qmm_route(M, K, N, 2, x_bf16, w_ptr, x_ptr)
    assert got == route
    assert (plan is None) == (route == "tiled")
    if route == "tensor_core":
        assert isinstance(plan, tqk.QmmTcPlan)


@pytest.mark.parametrize("M,bk,bn,ratio,elem,x_bf16,w_ptr,x_ptr,route", [
    (16, 128, 128, 2, 1, True, 0, 0, "thin_m"),       # decode rows
    (17, 128, 128, 2, 1, True, 0, 0, "tensor_core"),  # past thin-M
    (512, 64, 256, 4, 1, True, 16, 32, "tensor_core"),
    (512, 128, 128, 1, 1, True, 0, 0, "tensor_core"),  # int8 blocks
    (17, 128, 128, 2, 1, False, 0, 0, "tiled"),       # f32 x
    (512, 128, 128, 1, 2, True, 0, 0, "tensor_core"),  # bf16 blocks
    (512, 128, 128, 1, 4, True, 0, 0, "tensor_core"),  # f32 blocks
    (256, 5, 2, 1, 1, True, 0, 0, "tiled"),           # LeNet conv1 blocks
    (256, 10, 4, 2, 1, True, 0, 0, "tiled"),          # LeNet conv2 blocks
    (512, 32, 128, 2, 1, True, 0, 0, "tiled"),        # bk not whole steps
    (512, 128, 64, 2, 1, True, 0, 0, "tiled"),        # bn not a 128 tile
    (512, 128, 128, 2, 1, True, 8, 0, "tiled"),       # codes misaligned
    (512, 128, 128, 2, 1, True, 0, 8, "tiled"),       # x misaligned
    (17, 128, 128, 1, 4, True, 16, 32, "tensor_core"),  # f32 blocks past 16
    (17, 128, 128, 1, 4, False, 0, 0, "tiled"),       # f32 x past 16 rows
    (64, 128, 128, 1, 2, False, 0, 0, "tiled"),       # (bf16 blocks too)
    (512, 128, 128, 1, 4, True, 8, 0, "tiled"),       # f32 blocks misaligned
    (1, 128, 128, 1, 4, False, 0, 0, "thin_m"),       # f32 blocks, decode
    (8, 128, 128, 1, 4, True, 16, 0, "thin_m"),
    (16, 128, 128, 1, 2, True, 8, 0, "thin_m"),       # bf16: 8-byte rows
    (8, 128, 128, 1, 4, True, 8, 0, "tiled"),         # f32 rows of 16 bytes
    (8, 128, 128, 1, 2, False, 4, 0, "tiled"),        # bf16 rows of 8 bytes
    (8, 128, 128, 2, 4, True, 0, 0, "tiled"),         # packed, not 1-byte
    (8, 10, 4, 1, 4, False, 0, 0, "tiled"),           # LeNet conv2 blocks
])
def test_bsm_route_rule(M, bk, bn, ratio, elem, x_bf16, w_ptr, x_ptr, route):
    got, plan = tsk.bsm_route(M, bk, bn, ratio, 16, 8, x_bf16, w_ptr, elem,
                              x_ptr)
    assert got == route
    assert (plan is None) == (route == "tiled")
    if route == "tensor_core":
        assert isinstance(plan, tsk.BsmTcPlan)


def _split_steps(plan, steps):
    """Each K split's step range, as the tensor-core kernel cuts K."""
    return [(s * plan.steps_per_split,
             min((s + 1) * plan.steps_per_split, steps))
            for s in range(plan.k_splits)]


@pytest.mark.parametrize("M,K,N", [
    (17, 2048, 512), (40, 64, 128), (128, 2048, 2048), (512, 2048, 512),
    (512, 8192, 2048), (512, 2048, 8192), (1024, 128, 384),
    (128, 512, 320), (64, 8192, 320), (24, 1024, 48), (1088, 3072, 32064),
    (4096, 1280, 504), (64, 8192, 504), (512, 2048, 328)])
def test_qmm_tc_plan_splits_cover_k_once(M, K, N):
    plan = tqk.qmm_tc_plan(M, K, N)
    spans = _split_steps(plan, K // tqk.TC_K_STEP)
    assert spans[0][0] == 0 and spans[-1][1] == K // tqk.TC_K_STEP
    assert all(lo < hi for lo, hi in spans)                  # none empty
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    steps = K // tqk.TC_K_STEP
    assert plan.steps_per_split >= min(tqk.TC_MIN_STEPS, steps)
    assert plan.m_tile in (64, 128) and (M > 64 or plan.m_tile == 64)
    assert plan.n_tile == tqk.TC_COLS


@pytest.mark.parametrize("M,K,N", [
    (128, 512, 320), (64, 8192, 320), (24, 1024, 48), (1088, 3072, 32064),
    (40, 2048, 4112)])
def test_qmm_tc_plan_tiles_a_ragged_n_as_its_whole_tiles(M, K, N):
    """A ragged N runs ceil(N / 128) column tiles, the last one partly
    empty: the plan (tiles, K splits) is the one of N rounded up to whole
    tiles, and its tiles cover N with less than one tile to spare."""
    plan = tqk.qmm_tc_plan(M, K, N)
    whole = -(-N // tqk.TC_COLS) * tqk.TC_COLS
    assert plan == tqk.qmm_tc_plan(M, K, whole)
    assert whole - plan.n_tile < N <= whole


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_qmm_candidates_at_the_hubert_head_pass_the_plan_check(ratio):
    """hubert-xlarge's head (1280 x 504 at its forward's 4096 rows): every
    candidate passes ``qmm_plan_error``; the rule's own is first, on the
    tensor-core route with 4 column tiles, the last 120 columns wide, and
    8-byte aligned codes are enough."""
    args = (4096, 1280, 504, ratio, True, 8, 512)
    cands = tqk.qmm_candidates(*args)
    assert cands[0] == tqk.qmm_route(*args)
    route, plan = cands[0]
    assert route == "tensor_core"
    assert -(-504 // plan.n_tile) == 4 and 504 - 3 * plan.n_tile == 120
    assert ("tiled", None) in cands
    for route, plan in cands:
        assert tqk.qmm_plan_error(route, plan, *args) is None, (route, plan)
    assert tqk.qmm_plan_error(*cands[0], 4096, 1280, 504, ratio, True, 4,
                              512) is not None


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_qmm_candidates_at_the_phi3_head_pass_the_plan_check(ratio):
    """Every candidate the autotuner would time at phi-3-vision-4.2b's head
    (3072 x 32,064, its forward's 1088 rows) passes ``qmm_plan_error``; the
    rule's own is first, on the tensor-core route, and the tiled route is
    among them."""
    args = (1088, 3072, 32064, ratio, True, 256, 512)
    cands = tqk.qmm_candidates(*args)
    assert cands[0] == tqk.qmm_route(*args)
    assert cands[0][0] == "tensor_core"
    assert ("tiled", None) in cands
    assert sum(r == "tensor_core" for r, _ in cands) > 1
    for route, plan in cands:
        assert tqk.qmm_plan_error(route, plan, *args) is None, (route, plan)


def _ranges(sched, per):
    """Each column's schedule-entry ranges of ``per`` whole blocks."""
    col_ptr = sched.col_ptr.numpy()
    return [[(lo, min(lo + per, col_ptr[c + 1]))
             for lo in range(col_ptr[c], col_ptr[c + 1], per)]
            for c in range(sched.n_col_blocks)]


def _top_blocks(rng, nR, nC, density):
    """A bitmap as compile_model picks one from random weights: the top
    ``density`` of blocks by a random score."""
    score = rng.random(nR * nC)
    keep = np.argsort(score)[-int(np.ceil(density * score.size)):]
    bitmap = np.zeros(nR * nC, bool)
    bitmap[keep] = True
    return bitmap.reshape(nR, nC)


def _llama_mlp_schedules():
    cfg = get_config("llama3.2-1b")
    D, F = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(0)
    up = _top_blocks(rng, D // 128, F // 128, 0.25) \
        | _top_blocks(rng, D // 128, F // 128, 0.25)
    down = _top_blocks(rng, F // 128, D // 128, 0.25)
    return {name: tsk.make_schedule(*np.nonzero(b), *b.shape, "cpu")
            for name, b in (("wg", up), ("wd", down))}


@pytest.mark.parametrize("leaf,M", [("wg", 512), ("wd", 512), ("wg", 128),
                                    ("wd", 128), ("wg", 40)])
def test_llama_mlp_leaves_fill_the_card_on_the_tc_route(leaf, M):
    """The compiled forward's MLP leaves (int4x2 blocks of 128 x 128): each
    column's blocks covered once, in order, by its ranges; the grid reaches
    about one wave of the card (one CTA per SM), and ranges cut a column
    only up to about one wave."""
    sched = _llama_mlp_schedules()[leaf]
    nC = sched.n_col_blocks
    route, plan = tsk.bsm_route(M, 128, 128, 2, nC, sched.max_blocks_per_col,
                                True)
    assert route == "tensor_core"
    col_ptr = sched.col_ptr.numpy()
    for c, rs in enumerate(_ranges(sched, plan.blocks_per_range)):
        assert rs[0][0] == col_ptr[c] and rs[-1][1] == col_ptr[c + 1]
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
        assert len(rs) <= plan.ranges_per_col
    tiles = -(-M // plan.m_tile) * nC
    grid = tiles * plan.ranges_per_col
    assert grid >= 0.9 * tsk.TC_SMS
    assert plan.ranges_per_col == 1 or grid <= 1.5 * tsk.TC_SMS


@pytest.mark.parametrize("leaf,M,K,N", [
    ("attn/wq", 512, 2048, 2048), ("attn/wk", 512, 2048, 512),
    ("attn/wq", 128, 2048, 2048), ("attn/wo", 128, 2048, 2048)])
def test_llama_quant_leaves_fill_the_card_on_the_tc_route(leaf, M, K, N):
    """The compiled forward's attention leaves (int4x2 along K): K splits
    bring each grid to about one wave of the card (one CTA per SM)."""
    route, plan = tqk.qmm_route(M, K, N, 2, True)
    assert route == "tensor_core"
    grid = -(-M // plan.m_tile) * (N // plan.n_tile) * plan.k_splits
    assert 0.9 * tsk.TC_SMS <= grid <= 1.5 * tsk.TC_SMS, (leaf, plan)


# The plans the rules give at the compiled forward's shapes and a few
# prefill widths: the fastest of the plans timed on the H100 at each shape
# (PERF.md, PR 16), except mlp/wd at M = 128 (6 blocks x 4 ranges; 5 x 5
# measured 6% faster).
@pytest.mark.parametrize("M,K,N,m_tile,k_splits", [
    (512, 2048, 2048, 128, 2),    # attn/wq, wo
    (512, 2048, 512, 64, 4),      # attn/wk, wv
    (256, 2048, 2048, 64, 2),
    (128, 2048, 2048, 64, 4),
    (128, 2048, 512, 64, 8),      # TC_MIN_STEPS caps the splits
    (40, 2048, 2048, 64, 8),
])
def test_qmm_tc_plan_at_llama_shapes(M, K, N, m_tile, k_splits):
    plan = tqk.qmm_tc_plan(M, K, N)
    assert (plan.m_tile, plan.k_splits) == (m_tile, k_splits)


@pytest.mark.parametrize("leaf,M,m_tile,per,ranges", [
    ("wg", 512, 64, 11, 1),       # 512 64-row tiles: no ranges
    ("wd", 512, 128, 11, 2),
    ("wg", 256, 64, 11, 1),
    ("wg", 128, 128, 6, 2),
    ("wd", 128, 64, 6, 4),
    ("wg", 40, 64, 6, 2),         # M fits one 64-row tile
])
def test_bsm_tc_plan_at_llama_shapes(leaf, M, m_tile, per, ranges):
    """At the random patterns' fullest columns: 11 blocks for wg, 22 for
    wd, as in the patterns timed on the card."""
    nC, max_col = {"wg": (64, 11), "wd": (16, 22)}[leaf]
    plan = tsk.bsm_tc_plan(M, 128, 128, nC, max_col)
    assert (plan.m_tile, plan.blocks_per_range, plan.ranges_per_col) == (
        m_tile, per, ranges)


@pytest.mark.parametrize("leaf,M,eb,m_tile", [
    ("wg", 512, 4, 128), ("wd", 512, 4, 128), ("wg", 128, 4, 128),
    ("wg", 40, 4, 64),            # one 64-row tile holds M
    ("wg", 512, 2, 64), ("wd", 512, 2, 128),   # bf16: the 1-byte rule's
])
def test_bsm_tc_plan_takes_128_rows_for_f32_blocks(leaf, M, eb, m_tile):
    """f32 blocks past 64 rows take 128-row tiles (half the tiles decode
    each 32 KB code tile); bf16 blocks keep the 1-byte containers' rule.
    The ranges follow the chosen tile as for every container."""
    nC, max_col = {"wg": (64, 11), "wd": (16, 22)}[leaf]
    route, plan = tsk.bsm_route(M, 128, 128, 1, nC, max_col, True, 0, eb)
    assert route == "tensor_core" and plan.m_tile == m_tile
    assert plan == tsk.bsm_tc_plan(M, 128, 128, nC, max_col, m_tile=m_tile)


# ----------------------------------------------------- the arithmetic order


def decode_tc(container, w):
    """The kernels' decode of a 1-byte container along K (axis -2) into
    exact bf16 codes: a field XOR its sign bit is code + 2^(bits-1); it is
    placed in the mantissa of bf16 128 (int8: f32 2^23) and taken off."""
    bits = 8 // RATIO[container]
    sign = 1 << (bits - 1)
    w = w.to(torch.uint8).to(torch.int32)
    fields = [((w >> (bits * t)) & ((1 << bits) - 1)) ^ sign
              for t in range(RATIO[container])]
    u = torch.stack(fields, dim=-2).flatten(-3, -2)   # interleave along K
    if bits == 8:
        f = (u | 0x4B000000).view(torch.float32) - (8388608.0 + sign)
        return f.to(torch.bfloat16)
    b = (u | 0x4300).to(torch.int16).view(torch.bfloat16)
    return b - torch.tensor(128.0 + sign, dtype=torch.bfloat16)


def _assert_within_a_bf16_step(y, ref):
    ref = np.asarray(ref, np.float64)
    mag = np.abs(ref)
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    err = np.abs(y.float().numpy().astype(np.float64) - ref)
    assert np.all(err <= step + 1e-6 * mag.max()), float(err.max())


def _case(rng, container, shape):
    q = QMAX[container]
    codes = rng.integers(-q, q + 1, size=shape).astype(np.int8)
    w = _t(codes)
    if container != "int8":
        w = pack_codes(w, axis=len(shape) - 2,
                       bits=8 // RATIO[container])
    return codes, w


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
@pytest.mark.parametrize("container", ["int8", "int4x2", "int2x4"])
def test_quant_tc_order_matches_the_reference(layer, container):
    """Layer 2: N = 192, a ragged last column tile (its missing code
    columns read as zeros, its missing outputs not written); layer 3: N =
    216, N % 16 == 8, the codes copied by cp.async, the columns past N
    zero-filled the same way."""
    rng = np.random.default_rng(10 * layer + RATIO[container])
    M, K, N = ((24, 512, 256), (40, 512, 384), (40, 512, 192),
               (40, 512, 216))[layer]
    codes, w = _case(rng, container, (K, N))
    dec = decode_tc(container, w)
    assert torch.equal(dec.float(), _t(codes).float())    # exact in bf16
    scales = (rng.random(N) / (QMAX[container] * 4)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32) if layer else None
    act = ("silu", None, "gelu", ("trelu", 0.05))[layer]
    x = _t(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    route, plan = tqk.qmm_route(M, K, N, RATIO[container], True)
    assert route == "tensor_core" and plan.k_splits > 1  # partials, a reduce
    # whole column tiles, the columns past N zero codes (as TMA fills them)
    tiles = -(-N // plan.n_tile)
    dec = torch.nn.functional.pad(dec, (0, tiles * plan.n_tile - N))
    acc = torch.zeros((M, tiles * plan.n_tile))
    for lo, hi in _split_steps(plan, K // tqk.TC_K_STEP):
        ks = slice(lo * tqk.TC_K_STEP, hi * tqk.TC_K_STEP)
        acc = acc + x[:, ks].float() @ dec[ks].float()
    y = acc[:, :N] * _t(scales)                     # scale at emit
    if bias is not None:
        y = y + _t(bias)
    y = tsk.apply_activation(y, act).to(torch.bfloat16)
    ref = j_qmm_ref(jnp.asarray(x.float().numpy()), jnp.asarray(codes),
                    jnp.asarray(scales),
                    bias=None if bias is None else jnp.asarray(bias),
                    activation=act)
    _assert_within_a_bf16_step(y, ref)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("container", ["int8", "int4x2", "int2x4"])
def test_block_sparse_tc_order_matches_the_reference(layer, container):
    """Per range of a column's blocks: bf16 x times the decoded block in
    f32, times the column's scale; ranges added in order; an absent column
    block emits act(b)."""
    rng = np.random.default_rng(20 * layer + RATIO[container])
    M, bk, bn, nR, nC = (24, 64, 128, 6, 3) if layer == 0 else \
        (40, 128, 128, 4, 4)
    bitmap = rng.random((nR, nC)) < 0.7
    bitmap[0, 0] = True
    bitmap[:, 1] = False                            # an absent column block
    rows, cols = np.nonzero(bitmap)
    codes, w = _case(rng, container, (rows.size, bk, bn))
    dec = decode_tc(container, w)
    assert torch.equal(dec.float(), _t(codes).float())
    scales = (rng.random(nC * bn) / (QMAX[container] * 4)).astype(np.float32)
    bias = rng.normal(size=nC * bn).astype(np.float32)
    act = ("gelu", ("trelu", 0.05))[layer]
    x = _t(rng.normal(size=(M, nR * bk)).astype(np.float32)).to(torch.bfloat16)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    route, plan = tsk.bsm_route(M, bk, bn, RATIO[container], nC,
                                sched.max_blocks_per_col, True)
    assert route == "tensor_core" and plan.ranges_per_col > 1
    srows, pidx = sched.rows.numpy(), sched.pidx.numpy()
    y = torch.zeros((M, nC * bn))
    for c, rs in enumerate(_ranges(sched, plan.blocks_per_range)):
        cs = slice(c * bn, (c + 1) * bn)
        for lo, hi in rs:
            part = torch.zeros((M, bn))
            for q in range(lo, hi):
                xk = x[:, srows[q] * bk:(srows[q] + 1) * bk].float()
                part = part + xk @ dec[pidx[q]].float()
            y[:, cs] = y[:, cs] + part * _t(scales[cs])  # scale at emit
    y = tsk.apply_activation(y + _t(bias), act).to(torch.bfloat16)
    ref = j_bsm_ref(jnp.asarray(x.float().numpy()), jnp.asarray(codes),
                    rows, cols, n_row_blocks=nR, n_col_blocks=nC,
                    scales=jnp.asarray(scales), bias=jnp.asarray(bias),
                    activation=act)
    _assert_within_a_bf16_step(y, ref)


def test_cpu_calls_count_no_tc_route():
    """On the CPU the wrappers take their plain versions: no route's
    counter moves, the tensor-core one included."""
    for mod in (tsk, tqk):
        for attr in ("launches", "launches_thin", "launches_tc",
                     "launches_tiled"):
            setattr(mod, attr, 0)
    rng = np.random.default_rng(5)
    codes, w = _case(rng, "int4x2", (128, 128))
    x = _t(rng.normal(size=(40, 128)).astype(np.float32)).to(torch.bfloat16)
    tqk.quant_matmul(x, w, torch.ones(128), packed="int4x2")
    sched = tsk.make_schedule(np.array([0]), np.array([0]), 2, 1, "cpu")
    blocks = pack_codes(_t(codes[:64][None]), axis=1, bits=4)
    tsk.block_sparse_matmul(x, blocks, sched, scales=torch.ones(128),
                            packed="int4x2")
    for mod in (tsk, tqk):
        assert (mod.launches, mod.launches_thin, mod.launches_tc,
                mod.launches_tiled) == (0, 0, 0, 0)
