"""Attention read over the quantised KV cache — kernel wrapper and plain
version.

The serving cache stores K/V as int4 codes, packed two per uint8 byte
along Dh (the int4x2 container) or one per int8 byte (the int4 container),
with one f32 scale per (slot, position, kv head).  The read attends
straight from codes x scales with an online softmax over ``bt``-row tiles,
skipping tiles at or past each query row's live length, so the result does
not depend on the cache extent at a fixed ``bt``.

* :func:`packed_decode_attention` — the wrapper of ``csrc/
  packed_decode_attention.cu`` (replacing the Pallas kernel of
  ``repro.kernels.flash_attention.decode_packed``), for decode (C = 1) and
  prefill chunks (C > 1), over either container.  :func:`pda_plan` picks
  the route from the shapes: the split kernel (the cache cut into fixed
  runs of whole tiles across CTAs, the query rows of a kv head into groups
  of at most 8, then a combine pass) or the single kernel (the first
  design).  CPU tensors take the plain version.
* :func:`tiled_packed_attention` — the plain PyTorch version, the same tile
  walk, masking and final ``acc / max(l, 1e-30)`` division.

Both can also return each query row's log-sum-exp of its scaled scores
(``return_lse``: ``m + log l``, -inf for a row with no live key, whose
output is 0): a sequence-sharded cache reads each rank's range with it and
combines the ranks' partial results (:func:`repro_torch.core.sharded.
seq_combine`).  The split kernel writes it in its combine pass; the single
kernel does not, and a read that asks for it there raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .. import build, refuse_dtensor
from ...core.quant import unpack_int4

__all__ = ["ATTN_BT_CANDIDATES", "PdaPlan", "launches", "launches_single",
           "launches_split", "packed_decode_attention", "pda_candidates",
           "pda_plan", "pda_plan_error", "tiled_packed_attention"]

NEG_INF = -1e30

# kernel launches since the counters were last set to 0: all of them, and
# those of each route
launches = 0
launches_split = 0
launches_single = 0

SPLIT_ROWS = 64          # cache rows per split, rounded to whole bt tiles
# query rows of one row group (one CTA), at most: on the H100 groups of 8
# beat those of 4, 16, 32 and 64 at the serving paths' 16-row chunks
# (scripts/pda_split_shapes.py), more CTAs sharing each tile through L2
SPLIT_MAX_QROWS = 8
# (Dh, bt) the split kernel is built for (`RT_SPLIT` in the source): a lane
# holds whole 4-byte words of one K row (of either container), 128 lanes
# per tile, and the CTA fits at a group's most rows
SPLIT_SHAPES = {(64, 16), (64, 32), (64, 64), (64, 128), (80, 64),
                (80, 128), (96, 32), (96, 64), (96, 128), (128, 16),
                (128, 32), (128, 64)}
SMEM_MAX = 232448        # shared memory a CTA may take on the H100
# kv tiles the autotuner tries: each has a split build at Dh 64; at Dh 80,
# 96 and 128 those of SPLIT_SHAPES do, the rest take the single kernel
ATTN_BT_CANDIDATES = (16, 32, 64, 128)


class PdaPlan(NamedTuple):
    """The split kernel's grid: ``n_splits`` runs of ``tiles_per_split``
    whole ``bt``-row tiles from cache row 0 (the last run may be shorter),
    times ``n_groups`` groups of ``group_rows`` query rows of a kv head
    (the last may hold fewer), times the kv heads, times the slots."""
    tiles_per_split: int
    n_splits: int
    n_groups: int
    group_rows: int


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def split_v_ld(Dh: int) -> int:
    """Row stride in floats of the split kernel's f32 V tile (``v_ld`` in
    the source): the least value >= Dh that is 16 mod 32, so P·V's reads of
    rows t and t + 1 fall in different banks."""
    return Dh + (16 - Dh) % 32


def split_code_align(Dh: int, packed: bool = True) -> int:
    """Byte alignment the split kernel needs of the code leaves and their
    slot stride (``code_piece`` in the source): its cp.async pieces are 16
    bytes where a row's code bytes (Dh / 2 int4x2, Dh int8) are a multiple
    of 16, else 8 (Dh 80 int4x2: 40-byte rows)."""
    return 16 if (Dh // 2 if packed else Dh) % 16 == 0 else 8


def split_row_groups(rows: int, cap: int = SPLIT_MAX_QROWS) -> tuple:
    """``(n_groups, group_rows)``: the ``rows`` = C·G query rows of a kv
    head in the fewest groups of at most ``cap`` (the rule's:
    :data:`SPLIT_MAX_QROWS`), as equal as they can be (144 -> 18 of 8, 100
    -> 13 of 8, 9 -> 2 of 5; the last group may hold fewer)."""
    n = max(1, -(-rows // cap))
    per = -(-rows // n)
    return -(-rows // per), per


def split_smem_bytes(bt: int, Dh: int, rows: int, packed: bool = True) -> int:
    """Shared memory of one split CTA serving ``rows`` query rows
    (``SplitSmem`` in the source): two ring stages of K and V codes (a
    row: Dh / 2 bytes int4x2, Dh int8) and scales, the f32 V tile (rows of
    :func:`split_v_ld` floats), q rows, acc, scores, m / l / corr and
    lengths."""
    row = Dh // 2 if packed else Dh
    stage = _align16(2 * bt * row) + _align16(8 * bt)
    return (2 * stage + 4 * bt * split_v_ld(Dh) + 8 * rows * Dh
            + _align16(4 * rows * bt) + 4 * _align16(4 * rows))


def pda_plan(B: int, C: int, H: int, Hkv: int, Dh: int, T: int, bt: int,
             kv_addr: int = 0, packed: bool = True) -> Optional[PdaPlan]:
    """The route of a packed attention read, as a shape rule: the split
    plan when ``(Dh, bt)`` is one of :data:`SPLIT_SHAPES`, ``kv_addr`` (the
    code leaves' addresses and slot stride in bytes, OR-ed) has the
    build's alignment (:func:`split_code_align`: 16 bytes, 8 for Dh 80's
    40-byte int4x2 rows) and a CTA's shared memory fits at a group's rows;
    ``None`` — the single kernel — otherwise.  ``packed`` names the
    container (int4x2, else int8 codes), which sets the bytes a row's codes
    take.

    A split is ``max(1, SPLIT_ROWS // bt)`` tiles: it depends on ``bt``
    alone, never on the extent ``T``, which only sets how many splits the
    grid has.  The ``C·H/Hkv`` query rows of a (slot, kv head) fall into
    :func:`split_row_groups`, one CTA a group, and a row's arithmetic does
    not depend on its group.  So a row's result does not depend on ``T``,
    as long as ``T`` holds its live rows."""
    rows = C * (H // Hkv)
    if (Dh, bt) not in SPLIT_SHAPES or rows < 1 \
            or kv_addr % split_code_align(Dh, packed):
        return None
    n_groups, group_rows = split_row_groups(rows)
    if split_smem_bytes(bt, Dh, group_rows, packed) > SMEM_MAX:
        return None
    per = max(1, SPLIT_ROWS // bt)
    n_t = max(1, -(-T // bt))
    return PdaPlan(per, -(-n_t // per), n_groups, group_rows)


def pda_plan_error(route: str, plan, B: int, C: int, H: int, Hkv: int,
                   Dh: int, T: int, bt: int, kv_addr: int = 0,
                   packed: bool = True) -> Optional[str]:
    """Why ``route`` ("split" or "single") cannot read this cache (the
    arguments of :func:`pda_plan`), or None when it can.  ``plan`` must be
    None: the split plan follows from ``bt`` and ``T``.  Pure: the
    wrapper's check of a given route."""
    if plan is not None:
        return "the attention read takes a route and bt, no plan"
    if bt < 1:
        return f"bt must be positive, got {bt}"
    if route == "single":
        return None
    if route == "split":
        if pda_plan(B, C, H, Hkv, Dh, T, bt, kv_addr, packed) is None:
            return (f"the split route needs (Dh, bt) in {sorted(SPLIT_SHAPES)}"
                    f", the shared memory and codes aligned to "
                    f"{split_code_align(Dh, packed)} bytes; got Dh={Dh}, "
                    f"bt={bt}, {C * (H // Hkv)} query rows a kv head, "
                    f"codes at {kv_addr}")
        return None
    return f"unknown route {route!r}"


def pda_candidates(B: int, C: int, H: int, Hkv: int, Dh: int, T: int,
                   kv_addr: int = 0, packed: bool = True):
    """``(route, bt)`` candidates of a packed attention read for the
    autotuner: each of :data:`ATTN_BT_CANDIDATES` on the route
    :func:`pda_plan` names for it — split where it has a plan, single
    otherwise.  The rule's own tile is the engine's default, 64."""
    return [("single" if pda_plan(B, C, H, Hkv, Dh, T, bt, kv_addr, packed)
             is None else "split", bt) for bt in ATTN_BT_CANDIDATES]


def _lib(route: str):
    lib = build.library("packed_decode_attention")
    if route == "split":
        fn = lib.pda_split_launch
        if fn.argtypes is None:
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [P, I, ctypes.c_float, P, P, P, P, P, P, P, P, I,
                           I, I, I, I, I, I, I, I, I, I, I, L, L, P]
            fn.restype = ctypes.c_int
        return fn
    fn = lib.pda_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, L, L,
                       P]
        fn.restype = ctypes.c_int
    return fn


def _slot_stride(t: torch.Tensor, inner, what: str, name: str) -> int:
    """Slot (axis 0) stride of a cache leaf whose other axes are dense."""
    if tuple(t.stride()[1:]) != tuple(inner):
        raise ValueError(
            f"{name}: {what} must be dense past its slot axis (strides "
            f"{tuple(t.stride())}, expected (*, {', '.join(map(str, inner))}))")
    return int(t.stride(0))


def packed_decode_attention(
    q: torch.Tensor,        # (B, C, H, Dh)
    k_p: torch.Tensor,      # (B, T, Hkv, Dh/2) uint8, or (B, T, Hkv, Dh)
    v_p: torch.Tensor,      #   int8 codes when packed=False
    k_s: torch.Tensor,      # (B, T, Hkv) f32
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C) live length per query row
    *,
    bt: int = 64,
    packed: bool = True,
    name: str = "packed_decode_attention",
    route: Optional[str] = None,
    return_lse: bool = False,
):
    """Attention of C query rows per slot over the quantised cache, in q's
    dtype.  Cache leaves may be views whose slot stride exceeds T rows
    (a bounded extent of a longer cache).  ``route`` ("split" / "single")
    replaces the rule's (:func:`pda_plan`) on CUDA tensors; one the read
    cannot take (:func:`pda_plan_error`) raises.  ``return_lse`` returns
    ``(out, lse)`` with ``lse`` f32 (B, C, H), on the split route only."""
    global launches, launches_split, launches_single
    refuse_dtensor(name, q, k_p, v_p, k_s, v_s, lengths)
    if not q.is_cuda:
        return tiled_packed_attention(q, k_p, v_p, k_s, v_s, lengths, bt=bt,
                                      packed=packed, return_lse=return_lse)
    args = _plan_args(q, k_p, v_p, k_s, v_s, lengths, bt, packed, name)
    if route is not None:
        from .. import check_plan
        check_plan("packed_decode_attention", route, None, args, name=name)
    plan = None if route == "single" else pda_plan(*args)
    out = _launch(q, k_p, v_p, k_s, v_s, lengths, bt, plan, name,
                  return_lse)
    launches += 1
    if plan is None:
        launches_single += 1
    else:
        launches_split += 1
    return out


def _plan_args(q, k_p, v_p, k_s, v_s, lengths, bt: int, packed: bool,
               name: str):
    """Check CUDA operands; the arguments of :func:`pda_plan` for them."""
    B, C, H, Dh = q.shape
    T, Hkv, Dhp = (int(d) for d in k_p.shape[1:])
    if packed and (Dh % 2 or Dhp != Dh // 2):
        raise ValueError(
            f"{name}: the kernel needs an even head dim packed two codes per "
            f"byte, got Dh={Dh} with {Dhp} bytes per row")
    if not packed and Dhp != Dh:
        raise ValueError(
            f"{name}: int8 codes need Dh={Dh} bytes per row, got {Dhp}")
    if H % Hkv:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    if bt < 1:
        raise ValueError(f"{name}: bt must be positive, got {bt}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    code_dtype = torch.uint8 if packed else torch.int8
    for t, what in ((k_p, "k codes"), (v_p, "v codes")):
        if t.dtype != code_dtype or t.device != q.device:
            raise ValueError(
                f"{name}: {what} must be {code_dtype} on {q.device}")
    for t, what in ((k_s, "k_s"), (v_s, "v_s")):
        if t.dtype != torch.float32 or t.device != q.device \
                or tuple(t.shape[1:]) != (T, Hkv):
            raise ValueError(
                f"{name}: {what} must be f32 (B, {T}, {Hkv}) on {q.device}")
    kv_stride = _slot_stride(k_p, (Hkv * Dhp, Dhp, 1), "k_p", name)
    if _slot_stride(v_p, (Hkv * Dhp, Dhp, 1), "v_p", name) != kv_stride:
        raise ValueError(f"{name}: k_p and v_p slot strides differ")
    s_stride = _slot_stride(k_s, (Hkv, 1), "k_s", name)
    if _slot_stride(v_s, (Hkv, 1), "v_s", name) != s_stride:
        raise ValueError(f"{name}: k_s and v_s slot strides differ")
    if tuple(lengths.shape) != (B, C):
        raise ValueError(f"{name}: lengths must be (B, C) = {(B, C)}")
    kv_addr = k_p.data_ptr() | v_p.data_ptr() | kv_stride
    return B, C, H, Hkv, Dh, T, int(bt), kv_addr, packed


def _launch(q, k_p, v_p, k_s, v_s, lengths, bt: int, plan: Optional[PdaPlan],
            name: str = "packed_decode_attention", return_lse: bool = False):
    """Launch the split kernel with ``plan``, or the single kernel when it
    is None, on CUDA operands that passed :func:`_plan_args` (uint8 codes
    are the int4x2 container, int8 the int4 one); counts nothing (the
    wrapper counts).  ``return_lse`` (split only) returns ``(out, lse)``."""
    B, C, H, Dh = q.shape
    T, Hkv = int(k_p.shape[1]), int(k_p.shape[2])
    kv_stride, s_stride = int(k_p.stride(0)), int(k_s.stride(0))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, C, H, Dh), dtype=q.dtype, device=q.device)
    out_bf16 = int(q.dtype == torch.bfloat16)
    packed = int(k_p.dtype == torch.uint8)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cache = (k_p.data_ptr(), v_p.data_ptr(), k_s.data_ptr(), v_s.data_ptr(),
             lens.data_ptr())
    if plan is None:
        if return_lse:
            raise ValueError(
                f"{name}: the log-sum-exp comes from the split route's "
                f"combine pass, and this read takes the single kernel "
                f"(Dh={Dh}, bt={bt}, {C * (H // Hkv)} query rows a kv head)")
        qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).contiguous()
        err = _lib("single")(qf.data_ptr(), *cache, out.data_ptr(), out_bf16,
                             packed, B, C, H, Hkv, Dh, T, bt, kv_stride,
                             s_stride, stream)
    else:
        # the kernel reads q in its dtype, four values a load, and scales it
        # in f32 itself
        qc = q.contiguous()
        if qc.data_ptr() % 16:
            qc = qc.clone()
        ws = torch.empty(B * Hkv * plan.n_splits * C * (H // Hkv) * (Dh + 2),
                         dtype=torch.float32, device=q.device)
        lse = torch.empty((B, C, H), dtype=torch.float32, device=q.device) \
            if return_lse else None
        err = _lib("split")(qc.data_ptr(), out_bf16, 1.0 / math.sqrt(Dh),
                            *cache, ws.data_ptr(), out.data_ptr(),
                            None if lse is None else lse.data_ptr(), packed,
                            B, C, H, Hkv, Dh, T, bt, plan.tiles_per_split,
                            plan.n_splits, plan.n_groups, plan.group_rows,
                            kv_stride, s_stride, stream)
    build.check(err, name)
    return (out, lse) if return_lse else out


def tiled_packed_attention(
    q: torch.Tensor,        # (B, C, H, Dh)
    k_c: torch.Tensor,      # packed uint8 (B, T, Hkv, ceil(Dh/2)), or int8
    v_c: torch.Tensor,      #   codes (B, T, Hkv, Dh) when packed=False
    k_s: torch.Tensor,      # (B, T, Hkv) f32
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C)
    *,
    bt: int = 64,
    packed: bool = True,
    return_lse: bool = False,
):
    """Plain version: tile-by-tile online softmax; a tile that is dead for
    a (b, c) row leaves that row's (m, l, acc) untouched.  Both containers
    decode to the same codes, so they give the same bits.  ``return_lse``
    returns ``(out, lse)``: ``m + log l`` per row, -inf where no key is
    live (the kernel's combine pass)."""
    B, C, H, Dh = q.shape
    T, Hkv = k_c.shape[1], k_c.shape[2]
    G = H // Hkv
    n_t = max(1, -(-T // bt))
    dev = q.device
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(B, C, Hkv, G, Dh)
    lengths = lengths.to(device=dev, dtype=torch.int32)

    m = torch.full((B, C, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, C, Hkv, G, Dh), dtype=torch.float32, device=dev)
    for it in range(n_t):
        lo, hi = it * bt, min((it + 1) * bt, T)
        if packed:
            codes_k = unpack_int4(k_c[:, lo:hi], Dh, axis=-1)
            codes_v = unpack_int4(v_c[:, lo:hi], Dh, axis=-1)
        else:
            codes_k, codes_v = k_c[:, lo:hi], v_c[:, lo:hi]
        kf = codes_k.to(torch.float32) * k_s[:, lo:hi, :, None]
        vf = codes_v.to(torch.float32) * v_s[:, lo:hi, :, None]
        s = torch.einsum("bcHgd,btHd->bcHgt", qf, kf)
        kpos = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        valid = kpos[None, None, :] < lengths[:, :, None]          # (B, C, t)
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] \
            + torch.einsum("bcHgt,btHd->bcHgd", p, vf)
        live = (lo < lengths)[:, :, None, None]                    # (B, C)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, C, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("-inf")))
    return out, lse.reshape(B, C, H)
