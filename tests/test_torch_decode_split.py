"""The split routes of the decode kernels, held against the JAX reference on
the CPU: ``bsm_plan`` (block_sparse_matmul's thin-M route: each column's
schedule entries cut into ranges across CTAs, partials added in range order)
and ``pda_plan`` (packed_decode_attention's split route: the cache cut into
fixed runs of whole tiles, per-split (m, l, acc) combined in split order).

The kernels themselves run only on a card; here the plans' arithmetic and
the algebra the kernels follow (per-range products with the scale applied
before the dot; per-split online softmax states rescaled by exp(m_s - m))
are replayed in plain PyTorch on numpy inputs made from a seed and compared
with ``repro``'s oracles, its Pallas kernels in interpret mode and its jnp
twin.  Tolerance: f32 ``rtol=1e-5, atol=1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import decode_packed as jdp  # noqa: E402
from repro.kernels.sparse_matmul import kernel as jsk  # noqa: E402
from repro.kernels.sparse_matmul.ref import block_sparse_matmul_ref as j_bsm_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.quant import pack_codes  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------- block_sparse_matmul


def _bitmap(rng, nR, nC, density, empty_cols=()):
    bitmap = rng.random((nR, nC)) < density
    bitmap[0, 0] = True
    for c in empty_cols:
        bitmap[:, c] = False
    return bitmap


def _top_blocks(rng, nR, nC, density):
    """A block bitmap as compile_model's shared bitmap picks it from random
    weights: the top ``density`` of blocks by a random score."""
    score = rng.random(nR * nC)
    keep = np.argsort(score)[-int(np.ceil(density * score.size)):]
    bitmap = np.zeros(nR * nC, bool)
    bitmap[keep] = True
    return bitmap.reshape(nR, nC)


def _thin_ranges(sched, plan):
    """Each column's entry ranges ``[(lo, hi), ...]`` as the thin-M kernel
    cuts them: ``blocks_per_range`` consecutive entries from the column's
    first, the last range shorter."""
    col_ptr = sched.col_ptr.numpy()
    per = plan.blocks_per_range
    return [[(lo, min(lo + per, col_ptr[c + 1]))
             for lo in range(col_ptr[c], col_ptr[c + 1], per)]
            for c in range(sched.n_col_blocks)]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("nR,nC,density,bk", [
    (16, 64, 0.4, 128), (64, 16, 0.25, 128), (12, 3, 0.6, 128),
    (2, 3, 1.0, 1024), (40, 5, 0.9, 32), (64, 64, 0.9, 128)])
def test_bsm_plan_ranges_cover_each_columns_entries_once_in_order(
        M, nR, nC, density, bk):
    rng = np.random.default_rng(nR * nC + M)
    bitmap = _bitmap(rng, nR, nC, density, empty_cols=(nC // 2,))
    rows, cols = np.nonzero(bitmap)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    np.testing.assert_array_equal(sched.col_counts, bitmap.sum(axis=0))
    plan = tsk.bsm_plan(M, bk, 128, 2, nC, sched.max_blocks_per_col)
    assert plan is not None
    col_ptr = sched.col_ptr.numpy()
    ranges = _thin_ranges(sched, plan)
    for c, rs in enumerate(ranges):
        if col_ptr[c] == col_ptr[c + 1]:
            assert rs == []           # a column with no block: emit only
            continue
        assert rs[0][0] == col_ptr[c] and rs[-1][1] == col_ptr[c + 1]
        assert all(lo < hi for lo, hi in rs)                 # none empty
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))  # in order
        assert all(hi - lo <= plan.blocks_per_range for lo, hi in rs)
        assert len(rs) <= plan.ranges_per_col
    # every range fits the kernel's x stage; one block per range unless the
    # grid would pass its cap, and then it stops within one range of it
    assert plan.blocks_per_range * bk * tsk.rows_per_cta(M) <= tsk.THIN_XCAP
    slices = nC * plan.col_slices
    if plan.blocks_per_range > 1:
        assert slices * sched.max_blocks_per_col > tsk.THIN_CTA_CAP
        assert slices * (plan.ranges_per_col - 1) < tsk.THIN_CTA_CAP


def test_llama_mlp_leaves_fill_the_card_on_the_thin_route():
    """llama3.2-1b's MLP leaves at decode (int4x2 blocks of 128 x 128, 25%
    of blocks kept, ``wg``/``wu`` sharing one pattern as compile_model's
    union): each launches >= 2 x 132 CTAs at M in {1, 8, 16}."""
    cfg = get_config("llama3.2-1b")
    D, F = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(0)
    up = _top_blocks(rng, D // 128, F // 128, 0.25) \
        | _top_blocks(rng, D // 128, F // 128, 0.25)
    down = _top_blocks(rng, F // 128, D // 128, 0.25)
    for name, bitmap in (("wg/wu", up), ("wd", down)):
        nR, nC = bitmap.shape
        rows, cols = np.nonzero(bitmap)
        sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
        for M in (1, 8, 16):
            plan = tsk.bsm_plan(M, 128, 128, 2, nC, sched.max_blocks_per_col)
            assert plan is not None, (name, M)
            grid = nC * plan.col_slices * plan.ranges_per_col
            assert 2 * 132 <= grid <= tsk.THIN_CTA_CAP, (name, M, plan)


@pytest.mark.parametrize("M,bk,bn,ratio,w_ptr,elem,route", [
    (1, 128, 128, 2, 0, 1, "thin"), (8, 128, 128, 4, 256, 1, "thin"),
    (16, 128, 128, 1, 4, 1, "thin"), (3, 32, 64, 2, 0, 1, "thin"),
    (17, 128, 128, 2, 0, 1, "tiled"), (128, 128, 128, 2, 0, 1, "tiled"),
    (512, 128, 128, 2, 0, 1, "tiled"),
    (8, 128, 128, 2, 2, 1, "tiled"),      # container not 4-byte aligned
    (8, 128, 128, 1, 0, 4, "thin"),       # f32 blocks: 16-byte rows
    (8, 128, 128, 1, 0, 2, "thin"),       # bf16 blocks: 8-byte rows
    (8, 128, 128, 1, 8, 4, "tiled"),      # f32 blocks not 16-byte aligned
    (8, 128, 128, 1, 4, 2, "tiled"),      # bf16 blocks not 8-byte aligned
    (8, 128, 128, 2, 0, 4, "tiled"),      # packed codes of 4-byte elements
    (8, 128, 90, 1, 0, 1, "tiled"),       # bn not a multiple of 4
    (8, 12, 128, 1, 0, 1, "tiled"),       # x rows not 16-byte loads
    (16, 2048, 128, 2, 0, 1, "tiled"),    # one block's x rows overflow
])
def test_bsm_route_rule(M, bk, bn, ratio, w_ptr, elem, route):
    plan = tsk.bsm_plan(M, bk, bn, ratio, 16, 8, w_ptr, elem)
    assert ("tiled" if plan is None else "thin") == route


def _range_sums(x, vals, scales, bias, act, sched, plan, bn):
    """The thin-M kernel's algebra in plain PyTorch: per range, each block
    dequantised per output column, then its dot; ranges added in order;
    bias and activation once."""
    M = x.shape[0]
    bk = vals.shape[1]
    N = sched.n_col_blocks * bn
    rows, pidx = sched.rows.numpy(), sched.pidx.numpy()
    out = torch.zeros((M, N))
    for c, rs in enumerate(_thin_ranges(sched, plan)):
        cs = slice(c * bn, (c + 1) * bn)
        s = torch.ones(bn) if scales is None else scales[cs]
        acc = torch.zeros((M, bn))
        for lo, hi in rs:
            part = torch.zeros((M, bn))
            for q in range(lo, hi):
                w = vals[pidx[q]].float() * s[None, :]     # scale first
                part = part + x[:, rows[q] * bk:(rows[q] + 1) * bk] @ w
            acc = acc + part
        out[:, cs] = acc
    if bias is not None:
        out = out + bias[None, :]
    return tsk.apply_activation(out, act)


@pytest.mark.parametrize("container,M,act,with_bias", [
    ("int8", 1, None, True), ("int4x2", 3, "silu", False),
    ("int2x4", 8, "gelu", True), ("int4x2", 16, ("trelu", 0.1), True),
    ("int8", 16, "relu", False)])
def test_bsm_range_sums_match_the_reference(container, M, act, with_bias):
    qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
    rng = np.random.default_rng(M + qm)
    nR, nC, bk, bn = 24, 4, 32, 16
    bitmap = _bitmap(rng, nR, nC, 0.5, empty_cols=(2,))
    rows, cols = np.nonzero(bitmap)
    vals = rng.integers(-qm, qm + 1, size=(rows.size, bk, bn)).astype(np.int8)
    scales = (rng.random(nC * bn) / (qm * 4)).astype(np.float32)
    bias = rng.normal(size=nC * bn).astype(np.float32) if with_bias else None
    x = rng.normal(size=(M, nR * bk)).astype(np.float32)
    sched = tsk.make_schedule(rows, cols, nR, nC, "cpu")
    plan = tsk.bsm_plan(M, bk, bn, 1, nC, sched.max_blocks_per_col)
    assert plan.ranges_per_col > 1          # several ranges per column
    y = _range_sums(_t(x), _t(vals), _t(scales),
                    None if bias is None else _t(bias), act, sched, plan, bn)
    ref = j_bsm_ref(jnp.asarray(x), jnp.asarray(vals), rows, cols,
                    n_row_blocks=nR, n_col_blocks=nC,
                    scales=jnp.asarray(scales),
                    bias=None if bias is None else jnp.asarray(bias),
                    activation=act)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)
    if container == "int4x2":
        # and the reference's thin-M Pallas entry on the packed container
        packed = pack_codes(_t(vals), axis=1, bits=4).numpy()
        ref_k = jsk.block_sparse_matmul_decode(
            jnp.asarray(x), jnp.asarray(packed), rows, cols,
            interpret=True, packed="int4x2", n_row_blocks=nR,
            n_col_blocks=nC, scales=jnp.asarray(scales),
            bias=None if bias is None else jnp.asarray(bias),
            activation=act)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_k), **TOL)


# -------------------------------------------------- packed_decode_attention


@pytest.mark.parametrize("bt", [16, 32, 64, 128])
def test_pda_plan_splits_are_whole_tiles_from_row_0_whatever_the_extent(bt):
    plans = {T: tdp.pda_plan(8, 1, 32, 8, 64, T, bt)
             for T in (1, bt, 200, 256, 512, 2048)}
    per = {p.tiles_per_split for p in plans.values()}
    assert len(per) == 1                    # the split does not move with T
    rows = per.pop() * bt
    assert rows % bt == 0 and rows >= min(bt, tdp.SPLIT_ROWS)
    for T, p in plans.items():
        bounds = [s * rows for s in range(p.n_splits + 1)]
        assert bounds[0] == 0 and all(b % bt == 0 for b in bounds)
        assert bounds[-2] < T <= bounds[-1]   # T sets only the count


def test_pda_plan_fills_the_card_at_the_decode_step():
    """8 slots, 8 kv heads, 200 live rows of a 256-row extent, bt 64: 256
    CTAs, where the single kernel has 64."""
    p = tdp.pda_plan(8, 1, 32, 8, 64, 256, 64)
    assert p.n_splits * 8 * 8 == 256


@pytest.mark.parametrize("C,H,Hkv,Dh,T,bt,kv_addr,route", [
    (1, 32, 8, 64, 256, 64, 0, "split"), (16, 32, 8, 64, 512, 64, 0, "split"),
    (1, 8, 8, 128, 100, 16, 4096, "split"), (4, 16, 2, 128, 64, 32, 0, "split"),
    (2, 4, 4, 64, 1000, 128, 0, "split"),
    (16, 16, 2, 64, 512, 64, 0, "split"),    # C·G = 128 rows: 16 row groups
    (1, 8, 2, 32, 100, 64, 0, "single"),     # a Dh the kernel is not built for
    (1, 8, 2, 256, 100, 64, 0, "single"),
    (1, 8, 2, 128, 100, 128, 0, "single"),   # a bt it is not built for
    (1, 8, 2, 64, 100, 24, 0, "single"),
    (1, 32, 8, 64, 256, 64, 8, "single"),    # codes not 16-byte aligned
])
def test_pda_route_rule(C, H, Hkv, Dh, T, bt, kv_addr, route):
    plan = tdp.pda_plan(2, C, H, Hkv, Dh, T, bt, kv_addr)
    assert ("single" if plan is None else "split") == route


@pytest.mark.parametrize("packed", [True, False])
def test_pda_split_shapes_fit_a_cta_at_the_most_query_rows(packed):
    """Every built (Dh, bt) fits a CTA at the most query rows, with int4x2
    codes (Dh / 2 bytes a row) and with int8 codes (Dh bytes)."""
    for Dh, bt in tdp.SPLIT_SHAPES:
        assert tdp.split_smem_bytes(bt, Dh, tdp.SPLIT_MAX_QROWS, packed) \
            <= tdp.SMEM_MAX
        assert tdp.pda_plan(8, 1, 32, 8, Dh, 512, bt, packed=packed) \
            == tdp.pda_plan(8, 1, 32, 8, Dh, 512, bt)
    assert tdp.split_smem_bytes(64, 128, 64, False) \
        - tdp.split_smem_bytes(64, 128, 64, True) == 2 * 2 * 64 * 64


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


def _split_states(q, k_p, v_p, k_s, v_s, lengths, bt, plan):
    """Each split's (m, l, acc) as the split kernel leaves them: the online
    softmax over its own tiles from (-1e30, 0, 0), a tile dead for a query
    row leaving that row's state untouched.  int8 codes (the int4
    container) are read as they are, uint8 ones unpacked."""
    from repro_torch.core.quant import unpack_int4

    def codes(c, lo, hi):
        return c[:, lo:hi] if c.dtype == torch.int8 \
            else unpack_int4(c[:, lo:hi], Dh, axis=-1)

    B, C, H, Dh = q.shape
    T, Hkv = k_p.shape[1], k_p.shape[2]
    G = H // Hkv
    n_t = max(1, -(-T // bt))
    qf = (q.float() / np.sqrt(Dh)).reshape(B, C, Hkv, G, Dh)
    states = []
    for s in range(plan.n_splits):
        m = torch.full((B, C, Hkv, G), NEG_INF)
        l = torch.zeros((B, C, Hkv, G))
        acc = torch.zeros((B, C, Hkv, G, Dh))
        lo_t = s * plan.tiles_per_split
        for it in range(lo_t, min(lo_t + plan.tiles_per_split, n_t)):
            lo, hi = it * bt, min((it + 1) * bt, T)
            kf = codes(k_p, lo, hi).float() * k_s[:, lo:hi, :, None]
            vf = codes(v_p, lo, hi).float() * v_s[:, lo:hi, :, None]
            sc = torch.einsum("bcHgd,btHd->bcHgt", qf, kf)
            kpos = torch.arange(lo, hi)
            valid = kpos[None, None, :] < lengths[:, :, None]
            sc = torch.where(valid[:, :, None, None, :], sc,
                             torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            live = (lo < lengths)[:, :, None, None]
            l = torch.where(live, l * corr + p.sum(dim=-1), l)
            acc = torch.where(live[..., None], acc * corr[..., None]
                              + torch.einsum("bcHgt,btHd->bcHgd", p, vf), acc)
            m = torch.where(live, m_new, m)
        states.append((m, l, acc))
    return states


def _combine(states, lengths, split_rows, shape):
    """The combine pass: the live splits of each query row, in split order,
    rescaled by exp(m_s - m); then acc / max(l, 1e-30)."""
    n_live = torch.clamp((lengths + split_rows - 1) // split_rows,
                         max=len(states))[:, :, None, None]
    m = torch.full_like(states[0][0], NEG_INF)
    for s, (m_s, _, _) in enumerate(states):
        m = torch.where(s < n_live, torch.maximum(m, m_s), m)
    acc = torch.zeros_like(states[0][2])
    l = torch.zeros_like(states[0][1])
    for s, (m_s, l_s, a_s) in enumerate(states):
        w = torch.exp(m_s - m)
        live = s < n_live
        acc = torch.where(live[..., None], acc + a_s * w[..., None], acc)
        l = torch.where(live, l + l_s * w, l)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(shape)


def _split_attention(q, k_p, v_p, k_s, v_s, lengths, bt):
    B, C, H, Dh = q.shape
    T, Hkv = k_p.shape[1], k_p.shape[2]
    plan = tdp.pda_plan(B, C, H, Hkv, Dh, T, bt)
    assert plan is not None
    states = _split_states(q, k_p, v_p, k_s, v_s, lengths, bt, plan)
    return _combine(states, lengths, plan.tiles_per_split * bt, q.shape), plan


@pytest.mark.parametrize("bt,lengths", [
    (16, [1, 37, 100, 64]),     # dead tiles, ragged tiles, a full cache
    (32, [100, 33, 2, 65]),
    (64, [63, 64, 65, 100])])
def test_split_combine_matches_the_reference_kernel_at_decode(bt, lengths):
    B, T, H, Hkv, Dh = 4, 100, 8, 2, 64
    q, k_p, v_p, k_s, v_s = _attn_case(B, 1, T, H, Hkv, Dh, seed=bt)
    length = np.array(lengths, np.int32)
    y, plan = _split_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                               _t(length[:, None]), bt)
    assert plan.n_splits > 1
    ref = jdp.packed_decode_attention(
        *(jnp.asarray(a) for a in (q, k_p, v_p, k_s, v_s)),
        jnp.asarray(length), bt=bt, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bt", [16, 64])
def test_split_combine_matches_the_reference_twin_for_a_prefill_chunk(
        bt, packed):
    """Both containers: int4x2 codes, and the same codes as int8 (the int4
    container, which the reference reads with its twin's packed=False)."""
    from repro_torch.core.quant import unpack_int4
    B, C, T, H, Hkv, Dh = 3, 16, 160, 8, 2, 64
    q, k_p, v_p, k_s, v_s = _attn_case(B, C, T, H, Hkv, Dh, seed=7 + bt)
    if not packed:
        k_p, v_p = (unpack_int4(_t(a), Dh, axis=-1).numpy()
                    for a in (k_p, v_p))
    # slot 0 starts empty (dead tiles for most rows), slot 1 ragged, slot 2
    # ends at the extent
    base = np.array([0, 69, T - C])
    lengths = (base[:, None] + np.arange(1, C + 1)[None, :]).astype(np.int32)
    y, plan = _split_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                               _t(lengths), bt)
    assert plan.n_splits > 1
    ref = jdp.tiled_packed_attention(
        *(jnp.asarray(a) for a in (q, k_p, v_p, k_s, v_s)),
        jnp.asarray(lengths), bt=bt, packed=packed)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


def test_cpu_calls_count_no_route():
    for attr in ("launches", "launches_split", "launches_single"):
        setattr(tdp, attr, 0)
    for attr in ("launches", "launches_thin", "launches_tiled"):
        setattr(tsk, attr, 0)
    q, k_p, v_p, k_s, v_s = _attn_case(2, 1, 40, 4, 2, 32, seed=3)
    tdp.packed_decode_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                                _t(np.array([[5], [40]], np.int32)), bt=16)
    rng = np.random.default_rng(4)
    bitmap = _bitmap(rng, 3, 2, 0.7)
    rows, cols = np.nonzero(bitmap)
    vals = _t(rng.integers(-7, 8, size=(rows.size, 32, 16)).astype(np.int8))
    tsk.block_sparse_matmul(_t(rng.normal(size=(2, 96)).astype(np.float32)),
                            pack_codes(vals, axis=1, bits=4),
                            tsk.make_schedule(rows, cols, 3, 2, "cpu"),
                            scales=torch.ones(32), packed="int4x2")
    assert (tdp.launches, tdp.launches_split, tdp.launches_single) == (0, 0, 0)
    assert (tsk.launches, tsk.launches_thin, tsk.launches_tiled) == (0, 0, 0)


# ------------------------------------------------------------------ on card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_split_routes_on_the_card(cuda_device):
    """Both new routes against their plain versions; the split attention
    gives the same bits at two cache extents and on a second call."""
    dev = cuda_device
    rng = np.random.default_rng(11)
    bitmap = _bitmap(rng, 16, 4, 0.5, empty_cols=(1,))
    rows, cols = np.nonzero(bitmap)
    vals = _t(rng.integers(-7, 8, size=(rows.size, 64, 128)).astype(np.int8))
    scales = _t((rng.random(512) / 28).astype(np.float32))
    x = _t(rng.normal(size=(8, 1024)).astype(np.float32))
    sched = tsk.make_schedule(rows, cols, 16, 4, dev)
    before = tsk.launches_thin
    y = tsk.block_sparse_matmul(x.to(dev), pack_codes(vals, axis=1, bits=4)
                                .to(dev), sched, scales=scales.to(dev),
                                activation="silu", packed="int4x2")
    assert tsk.launches_thin == before + 1
    ref = tsk.block_sparse_matmul(x, pack_codes(vals, axis=1, bits=4),
                                  tsk.make_schedule(rows, cols, 16, 4, "cpu"),
                                  scales=scales, activation="silu",
                                  packed="int4x2")
    np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    q, k_p, v_p, k_s, v_s = _attn_case(2, 16, 200, 8, 2, 64, seed=12)
    lengths = _t((np.array([[30], [120]]) + np.arange(16)).astype(np.int32))
    cpu = [_t(a) for a in (q, k_p, v_p, k_s, v_s)]
    on = [a.to(dev) for a in cpu]
    before = tdp.launches_split
    y = tdp.packed_decode_attention(*on, lengths.to(dev), bt=64)
    y2 = tdp.packed_decode_attention(*on, lengths.to(dev), bt=64)
    yb = tdp.packed_decode_attention(on[0], *(a[:, :160] for a in on[1:]),
                                     lengths.to(dev), bt=64)
    assert tdp.launches_split == before + 3
    assert torch.equal(y, y2) and torch.equal(y, yb)
    ref = tdp.tiled_packed_attention(*cpu, lengths, bt=64)
    # f32: the split combine reorders the online softmax's rescaling
    err = float((y.cpu() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


@pytest.mark.gpu
def test_int8_codes_give_the_packed_bits_on_both_routes(cuda_device):
    """The int4 container (int8 codes) on the card: on the split and the
    single route, the same bits as the int4x2 container holding the same
    codes, within one bf16 step of the plain version."""
    from repro_torch.core.quant import unpack_int4
    dev = cuda_device
    # the rule's split (C·G = 128: in row groups), and the single kernel
    for C, H, route in ((1, 8, None), (16, 16, None), (16, 16, "single")):
        q, k_p, v_p, k_s, v_s = _attn_case(2, C, 200, H, 2, 64, seed=13)
        lengths = _t((np.array([[30], [120]]) + np.arange(C))
                     .astype(np.int32)).to(dev)
        q = _t(q).to(dev).to(torch.bfloat16)
        k_p, v_p, k_s, v_s = (_t(a).to(dev) for a in (k_p, v_p, k_s, v_s))
        k_q, v_q = (unpack_int4(a, 64, axis=-1) for a in (k_p, v_p))
        y8 = tdp.packed_decode_attention(q, k_q, v_q, k_s, v_s, lengths,
                                         bt=64, packed=False, route=route)
        y4 = tdp.packed_decode_attention(q, k_p, v_p, k_s, v_s, lengths,
                                         bt=64, route=route)
        assert torch.equal(y8, y4)
        ref = tdp.tiled_packed_attention(q, k_q, v_q, k_s, v_s, lengths,
                                         bt=64, packed=False).float()
        err = float((y8.float() - ref).abs().max())
        assert err <= 2 ** -7 * float(ref.abs().max())
