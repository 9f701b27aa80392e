"""packed_decode_attention's split route at head dims 80 and 96 and in row
groups (more than ``SPLIT_MAX_QROWS`` query rows a kv head), held against
the JAX reference on the CPU.

The kernel runs only on a card.  Here its rule (``pda_plan``: the builds,
the row groups, the code alignment each build needs) is checked against
the source it describes, and the arithmetic the kernel follows is replayed
in plain PyTorch on numpy inputs made from a seed: one CTA a (slot, kv
head, split, row group), each serving its group's rows over the split's
tiles up to the group's longest row (rows past it zero-filled), its (m, l,
acc) written into the workspace at (b, h, split, r); then the combine pass
over each row's live splits, in split order.  A dead CTA writes nothing:
its workspace rows hold NaN, which the combine must never read.  The
replay is compared with ``repro``'s Pallas kernel in interpret mode at
decode and with its jnp twin for chunks.  Tolerance: f32 ``rtol=1e-5,
atol=1e-6``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import decode_packed as jdp  # noqa: E402
from repro_torch.core.quant import pack_codes, unpack_int4  # noqa: E402
from repro_torch.kernels import check_plan  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
NEG_INF = -1e30
SOURCE = (Path(tdp.__file__).resolve().parents[2] / "csrc"
          / "packed_decode_attention.cu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(B, C, T, H, Hkv, Dh, seed, packed=True):
    rng = np.random.default_rng(seed)
    codes_k = rng.integers(-7, 8, size=(B, T, Hkv, Dh)).astype(np.int8)
    codes_v = rng.integers(-7, 8, size=(B, T, Hkv, Dh)).astype(np.int8)
    if packed:
        codes_k, codes_v = (pack_codes(_t(c), axis=-1, bits=4).numpy()
                            for c in (codes_k, codes_v))
    k_s = (rng.random((B, T, Hkv)) / 7).astype(np.float32)
    v_s = (rng.random((B, T, Hkv)) / 7).astype(np.float32)
    q = rng.normal(size=(B, C, H, Dh)).astype(np.float32)
    return q, codes_k, codes_v, k_s, v_s


def _grouped_split_attention(q, k_c, v_c, k_s, v_s, lengths, bt, plan):
    """The split kernel's grid replayed: per (slot, split, row group) the
    online softmax over the split's tiles below the group's longest row,
    into the (b, h, split, r) workspace; then the combine pass."""
    B, C, H, Dh = q.shape
    T, Hkv = k_c.shape[1], k_c.shape[2]
    G, R = H // Hkv, C * (H // Hkv)
    n_t = max(1, -(-T // bt))
    per = plan.tiles_per_split
    # rows r = c·G + g of each (slot, kv head)
    qf = (q.float() / np.sqrt(Dh)).reshape(B, C, Hkv, G, Dh) \
        .permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, Dh)
    row_len = lengths[:, torch.arange(R) // G]                  # (B, R)
    ws_m = torch.full((B, Hkv, plan.n_splits, R), float("nan"))
    ws_l = torch.full_like(ws_m, float("nan"))
    ws_acc = torch.full((B, Hkv, plan.n_splits, R, Dh), float("nan"))

    def tile(c, s, lo, hi, row_end):
        codes = c[lo:hi].float() if c.dtype == torch.int8 \
            else unpack_int4(c[lo:hi], Dh, axis=-1).float()
        vals = codes * s[lo:hi, :, None]                        # (t, Hkv, Dh)
        vals[max(0, row_end - lo):] = 0.0        # zero-filled past row_end
        return vals

    for b in range(B):
        for sp in range(plan.n_splits):
            for grp in range(plan.n_groups):
                r0 = grp * plan.group_rows
                rows = slice(r0, min(R, r0 + plan.group_rows))
                lens = row_len[b, rows]
                lmax = int(lens.max())
                tiles = range(sp * per, min(sp * per + per, n_t,
                                            -(-lmax // bt)))
                if not len(tiles):
                    continue                     # dead CTA: writes nothing
                row_end = min(T, lmax)
                m = torch.full((Hkv, lens.numel()), NEG_INF)
                l = torch.zeros_like(m)
                acc = torch.zeros((Hkv, lens.numel(), Dh))
                for it in tiles:
                    lo, hi = it * bt, min((it + 1) * bt, T)
                    kf = tile(k_c[b], k_s[b], lo, hi, row_end)
                    vf = tile(v_c[b], v_s[b], lo, hi, row_end)
                    sc = torch.einsum("hrd,thd->hrt", qf[b, :, rows], kf)
                    valid = torch.arange(lo, hi)[None, :] < lens[:, None]
                    sc = torch.where(valid[None], sc,
                                     torch.full_like(sc, NEG_INF))
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    p = torch.exp(sc - m_new[..., None])
                    corr = torch.exp(m - m_new)
                    live = (lo < lens)[None]
                    l = torch.where(live, l * corr + p.sum(dim=-1), l)
                    acc = torch.where(live[..., None], acc * corr[..., None]
                                      + torch.einsum("hrt,thd->hrd", p, vf),
                                      acc)
                    m = torch.where(live, m_new, m)
                ws_m[b, :, sp, rows] = m
                ws_l[b, :, sp, rows] = l
                ws_acc[b, :, sp, rows] = acc

    split_rows = per * bt
    n_live = torch.clamp((row_len + split_rows - 1) // split_rows,
                         max=plan.n_splits)[:, None, :]         # (B, 1, R)
    m = torch.full((B, Hkv, R), NEG_INF)
    for sp in range(plan.n_splits):
        m = torch.where(sp < n_live, torch.maximum(m, ws_m[:, :, sp]), m)
    acc = torch.zeros((B, Hkv, R, Dh))
    l = torch.zeros((B, Hkv, R))
    for sp in range(plan.n_splits):
        live = sp < n_live
        w = torch.exp(ws_m[:, :, sp] - m)
        acc = torch.where(live[..., None], acc + ws_acc[:, :, sp] * w[..., None],
                          acc)
        l = torch.where(live, l + ws_l[:, :, sp] * w, l)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Hkv, C, G, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, C, H, Dh)


def _plan(B, C, H, Hkv, Dh, T, bt, packed=True):
    plan = tdp.pda_plan(B, C, H, Hkv, Dh, T, bt, packed=packed)
    assert plan is not None
    return plan


# ------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("Dh,G,bt", [(80, 1, 64), (80, 4, 128), (96, 1, 64),
                                     (96, 4, 32)])
def test_split_matches_the_reference_kernel_at_decode(Dh, G, bt):
    """Dead (0), short, ragged and full (T) slots at decode."""
    B, T, Hkv = 4, 200, 2
    H = G * Hkv
    q, k_p, v_p, k_s, v_s = _case(B, 1, T, H, Hkv, Dh, seed=Dh + G + bt)
    length = np.array([0, 37, 129, T], np.int32)
    plan = _plan(B, 1, H, Hkv, Dh, T, bt)
    assert plan.n_splits > 1 and plan.n_groups == 1
    y = _grouped_split_attention(*(_t(a) for a in (q, k_p, v_p, k_s, v_s)),
                                 _t(length[:, None]), bt, plan)
    assert torch.isfinite(y).all()
    ref = jdp.packed_decode_attention(
        *(jnp.asarray(a) for a in (q, k_p, v_p, k_s, v_s)),
        jnp.asarray(length), bt=bt, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("Dh,G,Hkv", [(80, 1, 2), (96, 4, 2), (128, 9, 1)])
def test_split_row_groups_match_the_reference_twin_for_a_chunk(Dh, G, Hkv,
                                                               packed):
    """16-row chunks: Dh 80 and 96, and starcoder2-7b's G 9 at Dh 128 (144
    query rows a kv head), over int4x2 codes and the same codes as int8;
    slot 0 starts empty, slot 1 ragged, slot 2 ends at the extent."""
    B, C, T, bt = 3, 16, 160, 64
    H = G * Hkv
    q, k_c, v_c, k_s, v_s = _case(B, C, T, H, Hkv, Dh, seed=Dh + G,
                                  packed=packed)
    base = np.array([0, 69, T - C])
    lengths = (base[:, None] + np.arange(1, C + 1)[None, :]).astype(np.int32)
    plan = _plan(B, C, H, Hkv, Dh, T, bt, packed)
    assert plan.n_groups == -(-C * G // tdp.SPLIT_MAX_QROWS) > 1
    y = _grouped_split_attention(*(_t(a) for a in (q, k_c, v_c, k_s, v_s)),
                                 _t(lengths), bt, plan)
    assert torch.isfinite(y).all()
    ref = jdp.tiled_packed_attention(
        *(jnp.asarray(a) for a in (q, k_c, v_c, k_s, v_s)),
        jnp.asarray(lengths), bt=bt, packed=packed)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cap", [1, 5, 64])
def test_a_rows_result_does_not_depend_on_its_group(cap):
    """The same chunk cut into other row groups (one row a group, groups of
    5 across query-head boundaries, one group) gives the rule's result."""
    B, C, T, H, Hkv, Dh, bt = 2, 16, 150, 18, 2, 80, 64
    q, k_p, v_p, k_s, v_s = _case(B, C, T, H, Hkv, Dh, seed=cap)
    lengths = _t((np.array([[3], [100]]) + np.arange(C)).astype(np.int32))
    args = [_t(a) for a in (q, k_p, v_p, k_s, v_s)]
    plan = _plan(B, C, H, Hkv, Dh, T, bt)
    alt = plan._replace(**dict(zip(("n_groups", "group_rows"),
                                   tdp.split_row_groups(C * H // Hkv, cap))))
    assert alt != plan
    np.testing.assert_allclose(
        _grouped_split_attention(*args, lengths, bt, alt).numpy(),
        _grouped_split_attention(*args, lengths, bt, plan).numpy(), **TOL)


# ------------------------------------------------------------------- rule


@pytest.mark.parametrize("C,H,Hkv,Dh,bt,kv_addr,packed,route", [
    (1, 32, 32, 80, 64, 0, True, "split"),      # zamba2-2.7b's decode read
    (1, 32, 32, 96, 64, 0, True, "split"),      # phi-3-vision-4.2b's
    (16, 32, 32, 96, 64, 0, True, "split"),     # its 16-row chunk
    (16, 36, 4, 128, 64, 0, True, "split"),     # starcoder2-7b's: 144 rows
    (16, 32, 32, 80, 128, 0, False, "split"),
    (1, 8, 2, 96, 32, 0, True, "split"),
    (16, 16, 2, 96, 128, 0, False, "split"),
    (1, 32, 32, 80, 64, 8, True, "split"),      # 40-byte rows: 8 bytes do
    (1, 32, 32, 80, 64, 4, True, "single"),
    (1, 32, 32, 80, 64, 8, False, "single"),    # 80-byte int8 rows need 16
    (1, 32, 32, 96, 64, 8, True, "single"),     # 48-byte rows need 16
    (1, 32, 32, 80, 32, 0, True, "single"),     # no build: a lane's slice
    (1, 32, 32, 96, 16, 0, True, "single"),     #   is not whole words
    (1, 32, 32, 48, 64, 0, True, "single"),     # no build of the head dim
])
def test_pda_route_rule_for_the_new_shapes(C, H, Hkv, Dh, bt, kv_addr,
                                           packed, route):
    plan = tdp.pda_plan(2, C, H, Hkv, Dh, 512, bt, kv_addr, packed)
    assert ("single" if plan is None else "split") == route
    err = tdp.pda_plan_error("split", None, 2, C, H, Hkv, Dh, 512, bt,
                             kv_addr, packed)
    assert (err is None) == (route == "split")
    if plan is not None:
        R = C * (H // Hkv)
        assert (plan.n_groups, plan.group_rows) == tdp.split_row_groups(R)
        check_plan("packed_decode_attention", "split", None,
                   (2, C, H, Hkv, Dh, 512, bt, kv_addr, packed))
    else:
        with pytest.raises(ValueError, match="cannot take route 'split'"):
            check_plan("packed_decode_attention", "split", None,
                       (2, C, H, Hkv, Dh, 512, bt, kv_addr, packed))


@pytest.mark.parametrize("cap", [1, 3, 8, 16, 64])
def test_row_groups_cover_each_row_once_as_equal_as_they_can_be(cap):
    for R in range(1, 300):
        n, per = tdp.split_row_groups(R, cap)
        assert per <= cap and n * per >= R > (n - 1) * per
        assert n == -(-R // cap)              # the fewest groups of <= cap
        assert per - (R - (n - 1) * per) < n  # the last short by < n rows


def test_row_groups_and_splits_do_not_move_with_the_extent():
    plans = {T: tdp.pda_plan(1, 16, 36, 4, 128, T, 64)
             for T in (1, 64, 200, 512, 2048)}
    assert {(p.tiles_per_split, p.n_groups, p.group_rows)
            for p in plans.values()} == {(1, 18, 8)}
    assert [p.n_splits for p in plans.values()] == [1, 1, 4, 8, 32]


@pytest.mark.parametrize("packed", [True, False])
def test_every_split_build_fits_a_cta_at_a_groups_most_rows(packed):
    """At the rule's group (SPLIT_MAX_QROWS rows) and at the 64 rows the
    kernel takes at most, for either container."""
    for Dh, bt in tdp.SPLIT_SHAPES:
        for rows in (tdp.SPLIT_MAX_QROWS, 64):
            assert tdp.split_smem_bytes(bt, Dh, rows, packed) <= tdp.SMEM_MAX
    assert tdp.split_smem_bytes(64, 80, 8, False) \
        - tdp.split_smem_bytes(64, 80, 8, True) == 2 * 2 * 64 * 40


def test_the_split_builds_and_the_rule_agree():
    """``RT_SPLIT`` lines of the source are exactly ``SPLIT_SHAPES``; the V
    tile's stride is 16 mod 32 floats for every built Dh, as the source's
    ``v_ld`` checks; a built shape gives every lane whole 4-byte words of
    a K row in either container."""
    text = SOURCE.read_text()
    built = {(int(a), int(b)) for a, b in
             re.findall(r"^\s*RT_SPLIT\((\d+),\s*(\d+)\)", text, re.M)}
    assert built == tdp.SPLIT_SHAPES
    src_ld = {int(d): int(v) for d, v in
              re.findall(r"v_ld<(\d+)>\(\) == (\d+)", text)}
    for Dh in {d for d, _ in built}:
        assert tdp.split_v_ld(Dh) % 32 == 16 and tdp.split_v_ld(Dh) >= Dh
        assert src_ld[Dh] == tdp.split_v_ld(Dh)
    for Dh, bt in built:
        assert 128 % bt == 0 and (Dh // (128 // bt)) % 8 == 0
    for Dh in (64, 80, 96, 128):
        for packed in (True, False):
            row = Dh // 2 if packed else Dh
            assert tdp.split_code_align(Dh, packed) \
                == (16 if row % 16 == 0 else 8)
    assert tdp.split_code_align(80) == 8


@pytest.mark.parametrize("Dh,want", [
    (80, ["single", "single", "split", "split"]),
    (96, ["single", "split", "split", "split"])])
def test_pda_candidates_name_split_for_the_built_tiles(Dh, want):
    cands = tdp.pda_candidates(8, 1, 32, 32, Dh, 512)
    assert cands == list(zip(want, tdp.ATTN_BT_CANDIDATES))
    assert [bt for r, bt in cands if r == "split"] \
        == sorted(bt for d, bt in tdp.SPLIT_SHAPES if d == Dh)
