"""Engine-free static block-sparse matmul and conv — the wrappers of the
CUDA kernels.

``y[M, N] = act(x[M, K] @ W + b)`` where W is stored block-compacted: only
present (bk, bn) blocks exist, enumerated by a static schedule.  The kernel
(``csrc/block_sparse_matmul.cu``) replaces the Pallas kernel of
``repro.kernels.sparse_matmul.kernel``; its plain PyTorch version is
:func:`repro_torch.kernels.sparse_matmul.ref.block_sparse_matmul_ref`.
:func:`block_sparse_conv` is the fused conv over the same block format
(``csrc/block_sparse_conv.cu``, plain version ``block_sparse_conv_ref``).

:func:`bsm_route` picks the matmul's route from the shapes: the thin-M
kernel (:func:`bsm_plan`: each column's blocks split across CTAs, a
deterministic second pass) for decode rows; the tensor-core kernel
(:func:`bsm_tc_plan`: wgmma tiles over each column's present blocks,
columns cut into ranges when the tiles alone are far from one wave of the
card) for bf16 rows past 16 at aligned block shapes; both over 1-byte
containers and f32 / bf16 blocks; the tiled kernel, the first design on the
CUDA cores, for the rest.  :func:`conv_route` picks the conv's route, for
this kernel and ``quant_conv`` alike: the register-tiled kernel (:class:`ConvPlan`:
accumulators, pool and epilogue in registers, K split across the warps of
a CTA to fill the card) where its plan fits, else the band kernel, the
first design.

A wrapper launches the kernel for CUDA tensors and takes the plain version
for CPU tensors, and only then.  ``launches`` counts launches of the
matmul kernels (``launches_thin``, ``launches_tc`` and ``launches_tiled``
those of each route), ``conv_launches`` those of the conv kernels
(``conv_launches_reg`` and ``conv_launches_band`` those of each route).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import build, refuse_dtensor

__all__ = ["ACTIVATIONS", "BsmPlan", "BsmTcPlan", "ConvPlan", "POOL_MODES",
           "Schedule", "apply_activation", "block_sparse_conv",
           "block_sparse_matmul", "bsm_candidates", "bsm_plan",
           "bsm_plan_error", "bsm_route", "bsm_tc_plan", "conv_launches",
           "conv_launches_band", "conv_launches_reg", "conv_route",
           "im2col_valid", "launches", "launches_tc", "launches_thin",
           "launches_tiled", "make_schedule", "pool_nhwc", "tuned_hits",
           "tuned_misses"]

# kernel launches since the counters were last set to 0
launches = 0         # block_sparse_matmul, every route
launches_thin = 0    # block_sparse_matmul, thin-M route
launches_tc = 0      # block_sparse_matmul, tensor-core route
launches_tiled = 0   # block_sparse_matmul, tiled route
conv_launches = 0    # block_sparse_conv, every route
conv_launches_reg = 0   # block_sparse_conv, register-tiled route
conv_launches_band = 0  # block_sparse_conv, band route
# block_sparse_matmul launches given a tuned plan: on it, or (the plan
# illegal for the call) on the shape rule's route and plan instead
tuned_hits = 0
tuned_misses = 0

THIN_M_MAX = 16      # rows of the thin-M route (decode batches)
THIN_COLS = 128      # output columns per CTA of the thin-M kernel
THIN_XCAP = 16384    # floats of x one thin-M CTA stages (its blocks' rows)
THIN_CTA_CAP = 8 * 132  # CTAs of a thin-M grid, at most: eight per H100 SM
TC_COLS = 128        # output columns per CTA of the tensor-core kernel
TC_K_STEP = 64       # codes of K per pipeline step of the tensor-core kernel
TC_SMS = 132         # SMs of an H100: a tensor-core grid aims at one CTA each
TC_MIN_STEPS = 4     # K steps per CTA, at least, of a grid cut along K
TC_LONG_STEPS = 12   # K steps a 128-row CTA needs to beat two 64-row CTAs

# Fused epilogue nonlinearities, applied in f32.  gelu is the tanh form,
# which is jax.nn.gelu's default (torch's own default is the erf form).
ACTIVATIONS = {
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
}
# activation codes of csrc/common.cuh (rt::Act)
_ACT_CODES = {None: 0, "relu": 1, "silu": 2, "gelu": 3}
_TRELU_CODE = 4


def apply_activation(v: torch.Tensor, activation) -> torch.Tensor:
    """A name from :data:`ACTIVATIONS`, ``("trelu", tau)`` (zero below
    ``tau``) or None."""
    if activation is None:
        return v
    if isinstance(activation, tuple):
        return torch.where(v > float(activation[1]), v, torch.zeros_like(v))
    return ACTIVATIONS[activation](v)


def _check_activation(activation) -> None:
    if activation is None or activation in ACTIVATIONS:
        return
    if (isinstance(activation, tuple) and len(activation) == 2
            and activation[0] == "trelu"
            and isinstance(activation[1], (int, float))):
        return
    raise ValueError(
        f"unknown epilogue activation {activation!r} — "
        f"supported: {sorted(ACTIVATIONS)}, ('trelu', tau) or None")


def act_args(activation):
    """(code, tau) of an activation for the CUDA epilogue."""
    _check_activation(activation)
    if isinstance(activation, tuple):
        return _TRELU_CODE, float(activation[1])
    return _ACT_CODES[activation], 0.0


def packed_ratio(packed) -> int:
    """Codes per container byte for a ``packed`` tag (False/None: 1,
    True/"int4x2": 2, "int2x4": 4)."""
    if packed in (False, None):
        return 1
    if packed in (True, "int4x2"):
        return 2
    if packed == "int2x4":
        return 4
    raise ValueError(
        f"unknown packed container tag {packed!r} — expected False, True, "
        f"'int4x2' or 'int2x4'")


def rows_per_cta(M: int) -> int:
    """Row tile of the matmul kernels: rows >= M inside the tile are
    masked, so thin decode batches are never padded in memory."""
    return 1 if M <= 1 else 8 if M <= 8 else 16


# container codes of csrc/common.cuh (rt::WKind)
_WKIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WKIND_PACKED = {2: 3, 4: 4}
X_DTYPES = (torch.float32, torch.bfloat16)


def w_kind(w: torch.Tensor, ratio: int, name: str) -> int:
    if ratio > 1:
        if w.dtype != torch.uint8:
            raise ValueError(
                f"{name}: a packed container must be uint8, got {w.dtype}")
        return _WKIND_PACKED[ratio]
    if w.dtype not in _WKIND:
        raise ValueError(
            f"{name}: the kernel takes f32, bf16 or int8 weights, got "
            f"{w.dtype}")
    return _WKIND[w.dtype]


def check_cuda_operand(t: torch.Tensor, device, what: str, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def vec_f32(v: Optional[torch.Tensor], N: int, device, what: str,
            name: str) -> Optional[torch.Tensor]:
    """A per-output-channel (N,) vector as contiguous f32, or None."""
    if v is None:
        return None
    if v.numel() != N:
        raise ValueError(f"{name}: {what} has {v.numel()} entries, N={N}")
    v = v.reshape(N).to(torch.float32).contiguous()
    check_cuda_operand(v, device, what, name)
    return v


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ----------------------------------------------------------------- schedule


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The static schedule of one pattern, in CSC form on one device.

    Present blocks sorted by (output column block, input row block), as the
    TPU kernel's ``_schedule`` orders them: the blocks of output column
    block ``c`` are entries ``col_ptr[c]:col_ptr[c + 1]``, each with its
    input row block ``rows[i]`` and its index ``pidx[i]`` into the compacted
    block stack.  ``block_rows`` / ``block_cols`` keep the pattern's own
    (row-major) coordinates on the host for the plain version.
    ``col_order`` lists the column blocks by falling block count (the
    tensor-core kernel starts the longest columns first).
    """

    col_ptr: torch.Tensor   # (n_col_blocks + 1,) int32
    rows: torch.Tensor      # (P,) int32
    pidx: torch.Tensor      # (P,) int32
    block_rows: np.ndarray
    block_cols: np.ndarray
    n_row_blocks: int
    n_col_blocks: int
    col_counts: np.ndarray  # (n_col_blocks,) present blocks per column, host
    max_blocks_per_col: int
    col_order: torch.Tensor  # (n_col_blocks,) int32, the fullest column first


def make_schedule(block_rows, block_cols, n_row_blocks: int,
                  n_col_blocks: int, device) -> Schedule:
    """Sort the present blocks by (col, row) and upload the CSC schedule."""
    block_rows = np.asarray(block_rows)
    block_cols = np.asarray(block_cols)
    order = np.lexsort((block_rows, block_cols))
    cols = block_cols[order].astype(np.int64)
    counts = np.bincount(cols, minlength=n_col_blocks).astype(np.int64)
    col_ptr = np.zeros(n_col_blocks + 1, np.int32)
    col_ptr[1:] = np.cumsum(counts)
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                       device=device)
    return Schedule(col_ptr=as_dev(col_ptr), rows=as_dev(block_rows[order]),
                    pidx=as_dev(order), block_rows=block_rows,
                    block_cols=block_cols, n_row_blocks=int(n_row_blocks),
                    n_col_blocks=int(n_col_blocks), col_counts=counts,
                    max_blocks_per_col=int(counts.max(initial=0)),
                    col_order=as_dev(np.argsort(-counts, kind="stable")))


class BsmPlan(NamedTuple):
    """The thin-M kernel's grid: each output column block's schedule
    entries cut into consecutive ranges of ``blocks_per_range`` blocks (the
    last may be shorter), ``ranges_per_col`` of them for the fullest
    column, times ``col_slices`` 128-column slices of a block."""
    blocks_per_range: int
    ranges_per_col: int
    col_slices: int


def bsm_plan(M: int, bk: int, bn: int, ratio: int, n_col_blocks: int,
             max_blocks_per_col: int, w_ptr: int = 0,
             elem_bytes: int = 1,
             blocks_per_range: Optional[int] = None) -> Optional[BsmPlan]:
    """The route of a block-sparse matmul, as a shape rule: the thin-M plan
    when ``M <= THIN_M_MAX``, the container is 1-byte (int8, int4x2, int2x4:
    ``elem_bytes`` 1) or unpacked f32 / bf16 blocks (``elem_bytes`` 4 or 2,
    ``ratio`` 1), ``bn % 4 == 0`` and the container's address ``w_ptr`` is
    aligned to 4 elements (each lane loads its 4 columns of a stored row in
    one 4-, 8- or 16-byte load), ``bk`` is a multiple of 8 (x rows staged
    in 16-byte loads) and one block's x rows fit the stage; ``None`` — the
    tiled kernel — otherwise.

    The plan cuts each column's blocks into ranges of whole blocks: one
    block per range, so the grid of column slices times the fullest
    column's ranges has the most CTAs, unless that grid would exceed
    :data:`THIN_CTA_CAP` CTAs (each range writes an f32 partial), and at
    most as many blocks as :data:`THIN_XCAP` staged x floats allow
    (:func:`thin_block_cap`).  ``blocks_per_range`` sets the blocks of a
    range instead (None when the cap does not allow it)."""
    if M > THIN_M_MAX or not _container_ok(ratio, elem_bytes) or bn % 4 \
            or w_ptr % (4 * elem_bytes) or bk % 8 or bk % ratio:
        return None
    cap = thin_block_cap(M, bk)
    if cap < 1:
        return None
    slices = -(-bn // THIN_COLS)
    if max_blocks_per_col == 0:
        return BsmPlan(1, 0, slices)
    if blocks_per_range is not None:
        if not 1 <= blocks_per_range <= cap:
            return None
        per = int(blocks_per_range)
    else:
        per = -(-max_blocks_per_col * n_col_blocks * slices // THIN_CTA_CAP)
        per = max(1, min(per, cap))
    return BsmPlan(per, -(-max_blocks_per_col // per), slices)


def _container_ok(ratio: int, elem_bytes: int) -> bool:
    """A container the thin-M and tensor-core kernels take: 1-byte codes
    (int8, or int4x2 / int2x4 packed along bk), or unpacked f32 / bf16
    blocks."""
    return elem_bytes == 1 or (elem_bytes in (2, 4) and ratio == 1)


def thin_block_cap(M: int, bk: int) -> int:
    """Blocks a thin-M range may hold: their x rows (``bk`` by the kernel's
    row tile for M rows) fit the :data:`THIN_XCAP` floats of the stage."""
    return THIN_XCAP // (bk * rows_per_cta(M))


def tc_cuts(tiles: int) -> int:
    """Cuts along K (K splits or ranges of a column's blocks) that bring a
    grid of ``tiles`` tiles nearest to one CTA per SM: ``TC_SMS / tiles``
    rounded, at least 1.  On the H100 one wave of about 132 CTAs measured
    faster than the next larger grid (two waves of shorter chains)."""
    return max(1, (2 * TC_SMS + tiles) // (2 * tiles))


def tc_m_tile(M: int, n_tiles: int, chain128: int) -> int:
    """Rows per CTA of the tensor-core kernels over ``n_tiles`` column
    tiles, given the K steps a 128-row CTA of the plan would walk
    (``chain128``): 64 when M fits one 64-row tile, or when 64-row tiles
    alone make about two waves (two 64-row CTAs share an SM and overlap
    each other's decode); else 128 when a 128-row CTA keeps at least
    :data:`TC_LONG_STEPS` steps (twice the rows per decoded code tile);
    else 64."""
    if M <= 64 or 2 * -(-M // 64) * n_tiles >= 3 * TC_SMS:
        return 64
    return 128 if chain128 >= TC_LONG_STEPS else 64


class BsmTcPlan(NamedTuple):
    """The tensor-core kernel's grid: ``m_tile`` rows (64 or 128) by
    ``n_tile`` columns of an output column block per CTA, by each column's
    schedule entries cut into ranges of ``blocks_per_range`` blocks,
    ``ranges_per_col`` of them for the fullest column."""
    m_tile: int
    n_tile: int
    blocks_per_range: int
    ranges_per_col: int


def bsm_tc_plan(M: int, bk: int, bn: int, n_col_blocks: int,
                max_blocks_per_col: int, m_tile: Optional[int] = None,
                cuts: Optional[int] = None,
                elem_bytes: int = 1) -> BsmTcPlan:
    """The tensor-core kernel's tiles and ranges: the fullest column's
    blocks cut into :func:`tc_cuts` ranges of whole blocks (one range, a
    whole column per CTA emitted in place, when the ``ceil(M / m_tile) *
    n_col_blocks * bn / TC_COLS`` tiles alone reach about one wave), each of
    at least :data:`TC_MIN_STEPS` steps, their partials added by a reduce
    pass; ``m_tile`` (64 or 128) by :func:`tc_m_tile` — 128 for f32 blocks
    (``elem_bytes`` 4) past 64 rows: their 32 KB code tile a step is
    decoded into two bf16 terms, and a 128-row tile halves the tiles that
    read and decode it (``chip_smoke.py`` ``route_pairs`` times both at the
    actsparse leaves) — and the cuts by :func:`tc_cuts` unless given."""
    n_tiles = n_col_blocks * (bn // TC_COLS)
    spb = bk // TC_K_STEP    # steps per block

    def plan(m):
        c = tc_cuts(-(-M // m) * n_tiles) if cuts is None else cuts
        per = -(-max_blocks_per_col // c)
        per = max(per, -(-TC_MIN_STEPS // spb))
        return BsmTcPlan(m, TC_COLS, per,
                         max(-(-max_blocks_per_col // per), 1))

    if m_tile is None and elem_bytes == 4 and M > 64:
        m_tile = 128
    if m_tile is None:
        m_tile = tc_m_tile(M, n_tiles, plan(128).blocks_per_range * spb)
    return plan(m_tile)


def bsm_route(M: int, bk: int, bn: int, ratio: int, n_col_blocks: int,
              max_blocks_per_col: int, x_bf16: bool, w_ptr: int = 0,
              elem_bytes: int = 1, x_ptr: int = 0):
    """``(route, plan)`` of a block-sparse matmul, as a shape rule.

    ``("thin_m", BsmPlan)`` when :func:`bsm_plan` gives a plan (M <= 16);
    else ``("tensor_core", BsmTcPlan)`` when x is bf16, the container is
    1-byte (int8, int4x2, int2x4) or f32 / bf16 blocks (f32 weights split
    into two bf16 terms), ``bk`` is a multiple of :data:`TC_K_STEP` (whole
    steps; x rows in 16-byte copies), ``bn`` a multiple of :data:`TC_COLS`
    (whole column tiles) and both ``x_ptr`` and ``w_ptr`` are 16-byte
    aligned; else ``("tiled", None)``, the CUDA-core kernel (f32 x past 16
    rows, small blocks such as LeNet's)."""
    plan = bsm_plan(M, bk, bn, ratio, n_col_blocks, max_blocks_per_col,
                    w_ptr, elem_bytes)
    if plan is not None:
        return "thin_m", plan
    if _bsm_tc_error(M, bk, bn, ratio, x_bf16, w_ptr, elem_bytes,
                     x_ptr) is None:
        return "tensor_core", bsm_tc_plan(M, bk, bn, n_col_blocks,
                                          max_blocks_per_col,
                                          elem_bytes=elem_bytes)
    return "tiled", None


def _bsm_tc_error(M, bk, bn, ratio, x_bf16, w_ptr, elem_bytes,
                  x_ptr) -> Optional[str]:
    """Why the tensor-core route cannot take these operands, or None."""
    if not x_bf16:
        return "the tensor-core route needs bf16 x"
    if M <= THIN_M_MAX:
        return f"the tensor-core route needs M > {THIN_M_MAX}, got {M}"
    if not _container_ok(ratio, elem_bytes):
        return ("the tensor-core route needs 1-byte codes or unpacked "
                "f32 / bf16 blocks")
    if bk % TC_K_STEP or bk % ratio or bn % TC_COLS:
        return (f"the tensor-core route needs bk % {TC_K_STEP} == 0 and "
                f"bn % {TC_COLS} == 0, got block ({bk}, {bn})")
    if w_ptr % 16 or x_ptr % 16:
        return "the tensor-core route needs 16-byte aligned x and blocks"
    return None


def _int_plan(plan, n: int, what: str):
    """``plan`` as a tuple of ``n`` ints (>= 0), or an error string."""
    try:
        t = tuple(int(v) for v in plan)
    except TypeError:
        return f"{what} needs a plan of {n} ints, got {plan!r}"
    if len(t) != n or any(v < 0 for v in t) or t != tuple(plan):
        return f"{what} needs a plan of {n} non-negative ints, got {plan!r}"
    return t


def bsm_plan_error(route: str, plan, M: int, bk: int, bn: int, ratio: int,
                   n_col_blocks: int, max_blocks_per_col: int, x_bf16: bool,
                   w_ptr: int = 0, elem_bytes: int = 1,
                   x_ptr: int = 0) -> Optional[str]:
    """Why ``route`` with ``plan`` (a :class:`BsmPlan` / :class:`BsmTcPlan`
    or its tuple of ints; None for "tiled") cannot take the block-sparse
    matmul of these operands (the arguments of :func:`bsm_route`), or None
    when it can.  Pure: the wrapper's check of a given plan."""
    if route == "tiled":
        return None if plan is None else "the tiled route takes no plan"
    if route == "thin_m":
        if bsm_plan(M, bk, bn, ratio, n_col_blocks, max_blocks_per_col,
                    w_ptr, elem_bytes) is None:
            return (f"the thin-M route needs M <= {THIN_M_MAX}, 1-byte "
                    f"codes or unpacked f32 / bf16 blocks, bn % 4 == 0, "
                    f"bk % 8 == 0 and blocks aligned to 4 elements, got "
                    f"M={M}, block ({bk}, {bn}), {ratio} codes and "
                    f"{elem_bytes} bytes an element")
        t = _int_plan(plan, 3, "the thin-M route")
        if isinstance(t, str):
            return t
        per, ranges, slices = t
        cap = thin_block_cap(M, bk)
        if not 1 <= per <= cap:
            return f"{per} blocks a range, the stage holds 1 to {cap}"
        if ranges != -(-max_blocks_per_col // per) \
                or slices != -(-bn // THIN_COLS):
            return (f"ranges {ranges} and slices {slices} do not cover "
                    f"{max_blocks_per_col} blocks of {bn} columns")
        return None
    if route == "tensor_core":
        err = _bsm_tc_error(M, bk, bn, ratio, x_bf16, w_ptr, elem_bytes,
                            x_ptr)
        if err is not None:
            return err
        t = _int_plan(plan, 4, "the tensor-core route")
        if isinstance(t, str):
            return t
        m_tile, n_tile, per, ranges = t
        if m_tile not in (64, 128) or n_tile != TC_COLS:
            return f"tiles {m_tile} x {n_tile}, not 64/128 x {TC_COLS}"
        if per * (bk // TC_K_STEP) < TC_MIN_STEPS \
                or ranges != max(-(-max_blocks_per_col // per), 1):
            return (f"{per} blocks a range over {ranges} ranges: ranges of "
                    f"at least {TC_MIN_STEPS} steps must cover "
                    f"{max_blocks_per_col} blocks")
        return None
    return f"unknown route {route!r}"


def bsm_candidates(M: int, bk: int, bn: int, ratio: int, n_col_blocks: int,
                   max_blocks_per_col: int, x_bf16: bool, w_ptr: int = 0,
                   elem_bytes: int = 1, x_ptr: int = 0):
    """``(route, plan)`` candidates of a block-sparse matmul for the
    autotuner, the rule's own (:func:`bsm_route`) first: the thin-M plan
    with 1, 2 or 4 blocks a range (legal at every thin M too, so a table
    tuned at one decode row count serves the others); the tensor-core
    plans with 64- and 128-row tiles crossed with 1, :func:`tc_cuts` and
    twice that many ranges a column; the tiled route, always legal.  Every
    one passes :func:`bsm_plan_error`."""
    args = (M, bk, bn, ratio, n_col_blocks, max_blocks_per_col, x_bf16,
            w_ptr, elem_bytes, x_ptr)
    out = [bsm_route(*args)]

    def add(route, plan, also_thin16=False):
        if (route, plan) in out or bsm_plan_error(route, plan, *args):
            return
        if also_thin16 and bsm_plan_error(
                route, plan, THIN_M_MAX, *args[1:]):
            return
        out.append((route, plan))

    if out[0][0] == "thin_m" and max_blocks_per_col:
        for per in (1, 2, 4):
            add("thin_m", bsm_plan(M, bk, bn, ratio, n_col_blocks,
                                   max_blocks_per_col, w_ptr, elem_bytes,
                                   blocks_per_range=per), True)
    elif _bsm_tc_error(M, bk, bn, ratio, x_bf16, w_ptr, elem_bytes,
                       x_ptr) is None:
        n_tiles = n_col_blocks * (bn // TC_COLS)
        for m in (64, 128):
            c = tc_cuts(-(-M // m) * n_tiles)
            for cuts in (1, c, 2 * c):
                add("tensor_core", bsm_tc_plan(
                    M, bk, bn, n_col_blocks, max_blocks_per_col, m_tile=m,
                    cuts=cuts))
    add("tiled", None)
    return out


# ------------------------------------------------------------------ wrapper


def _lib():
    lib = build.library("block_sparse_matmul")
    fn = lib.bsm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, I, I, I, P, P, P, P, P, I, P, I, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _thin_lib():
    fn = build.library("block_sparse_matmul").bsm_thin_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, I, I, I, P, P, P, P, P, I, I, I, P, P,
                       I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _tc_lib():
    fn = build.library("block_sparse_matmul").bsm_tc_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, I, I, I, I, P, P, P, P, P, P, I, I, I, P,
                       P, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def block_sparse_matmul(
    x: torch.Tensor,
    blocks: torch.Tensor,
    schedule: Schedule,
    *,
    scales: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    packed=False,
    name: str = "block_sparse_matmul",
    plan=None,
    tuned: bool = False,
) -> torch.Tensor:
    """y = act(x @ W + b) for a block-compacted W, in x's dtype.

    ``blocks`` is ``(P, bk, bn)`` (f32, bf16 or int8 codes with ``scales``)
    or, with ``packed`` "int4x2"/"int2x4", the uint8 container
    ``(P, bk / ratio, bn)`` packed along bk.  Columns whose block column is
    absent — every column of an empty pattern — come back as ``act(b)``.
    Any M >= 1 runs as is: the kernel's row tile masks the rows past M, so
    thin decode batches (the TPU kernel's separate decode entry) need no
    padding.  ``name`` labels errors (the dispatch passes the leaf name).

    ``plan``: a ``(route, plan)`` pair (:func:`bsm_candidates`) to launch
    instead of the shape rule's; one the call cannot take
    (:func:`bsm_plan_error`) raises — unless ``tuned`` (it came from a
    tuned table), when the rule's route and plan run instead, counted in
    ``tuned_misses``; a tuned plan that runs counts in ``tuned_hits``.
    """
    global launches, launches_thin, launches_tc, launches_tiled, \
        tuned_hits, tuned_misses
    refuse_dtensor(name, x, blocks, scales, bias)
    ratio = packed_ratio(packed)
    P, bkp, bn = (int(d) for d in blocks.shape)
    bk = bkp * ratio
    M, K = x.shape
    if K != schedule.n_row_blocks * bk:
        raise ValueError(
            f"{name}: K={K} != n_row_blocks*bk={schedule.n_row_blocks * bk}")
    shape = (M, bk, bn, ratio, schedule.n_col_blocks,
             schedule.max_blocks_per_col, x.dtype == torch.bfloat16,
             blocks.data_ptr(), blocks.element_size(), x.data_ptr())
    err = None if plan is None else bsm_plan_error(plan[0], plan[1], *shape)
    if err is not None and not tuned:
        from .. import check_plan
        check_plan("block_sparse_matmul", plan[0], plan[1], shape, name=name)
    if not x.is_cuda:
        from .ref import block_sparse_matmul_ref
        from ...core.quant import unpack_codes
        vals = unpack_codes(blocks, bk, axis=1, bits=8 // ratio) \
            if ratio > 1 else blocks
        return block_sparse_matmul_ref(
            x, vals, schedule.block_rows, schedule.block_cols,
            n_row_blocks=schedule.n_row_blocks,
            n_col_blocks=schedule.n_col_blocks, scales=scales, bias=bias,
            activation=activation, out_dtype=x.dtype)
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if M < 1:
        raise ValueError(f"{name}: needs at least one row, got M={M}")
    act_args(activation)
    w_kind(blocks, ratio, name)
    dev = x.device
    check_cuda_operand(x, dev, "x", name)
    check_cuda_operand(blocks, dev, "blocks", name)
    check_cuda_operand(schedule.col_ptr, dev, "the schedule", name)
    if P != int(schedule.rows.numel()):
        raise ValueError(
            f"{name}: {P} blocks but the schedule lists "
            f"{int(schedule.rows.numel())}")
    if plan is None or err is not None:
        if err is not None:
            tuned_misses += 1
        route, plan = bsm_route(*shape)
    else:
        tuned_hits += int(tuned)
        route = plan[0]
        plan = None if route == "tiled" else \
            (BsmPlan if route == "thin_m" else BsmTcPlan)(*plan[1])
    out = _launch(x, blocks, schedule, scales, bias, activation, ratio, route,
                  plan, name)
    launches += 1
    if route == "thin_m":
        launches_thin += 1
    elif route == "tensor_core":
        launches_tc += 1
    else:
        launches_tiled += 1
    return out


def _launch(x, blocks, schedule: Schedule, scales, bias, activation,
            ratio: int, route: str, plan=None,
            name: str = "block_sparse_matmul", ws=None) -> torch.Tensor:
    """Launch ``route``'s kernel ("thin_m" or "tensor_core" with its
    ``plan``, or "tiled") on CUDA operands that passed the wrapper's
    checks; counts nothing (the wrapper counts).  Any route may be asked
    for, to time one beside another.  ``ws``: the tensor-core route's
    (ranges_per_col, M, N) f32 workspace, kept by the caller to read the
    partials (else one is allocated)."""
    M, K = x.shape
    bn = int(blocks.shape[2])
    bk = int(blocks.shape[1]) * ratio
    code, tau = act_args(activation)
    kind = w_kind(blocks, ratio, name)
    dev = x.device
    N = schedule.n_col_blocks * bn
    s = vec_f32(scales, N, dev, "scales", name)
    b = vec_f32(bias, N, dev, "bias", name)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x_bf16 = int(x.dtype == torch.bfloat16)
    if route == "tiled":
        err = _lib()(ptr(x), x_bf16, M, K, ptr(blocks), kind, bk, bn, ptr(s),
                     ptr(b), ptr(schedule.col_ptr), ptr(schedule.rows),
                     ptr(schedule.pidx), schedule.n_col_blocks, ptr(out),
                     rows_per_cta(M), code, tau, stream)
    elif route == "tensor_core":
        if ws is None and plan.ranges_per_col > 1:
            ws = torch.empty((plan.ranges_per_col, M, N),
                             dtype=torch.float32, device=dev)
        err = _tc_lib()(ptr(x), M, K, ptr(blocks), kind, int(blocks.shape[0]),
                        bk, bn, ptr(s), ptr(b), ptr(schedule.col_ptr),
                        ptr(schedule.rows), ptr(schedule.pidx),
                        ptr(schedule.col_order), schedule.n_col_blocks,
                        plan.ranges_per_col,
                        plan.blocks_per_range, ptr(ws), ptr(out), plan.m_tile,
                        code, tau, stream)
    elif route == "thin_m":
        ws = torch.empty((max(plan.ranges_per_col, 1), M, N),
                         dtype=torch.float32, device=dev)
        err = _thin_lib()(ptr(x), x_bf16, M, K, ptr(blocks), kind, bk, bn,
                          ptr(s), ptr(b), ptr(schedule.col_ptr),
                          ptr(schedule.rows), ptr(schedule.pidx),
                          schedule.n_col_blocks, plan.ranges_per_col,
                          plan.blocks_per_range, ptr(ws), ptr(out),
                          rows_per_cta(M), code, tau, stream)
    else:
        raise ValueError(f"{name}: unknown route {route!r}")
    build.check(err, name)
    return out


# -------------------------------------------------------------------- conv

# Fused pooling modes of the conv kernels' emit step.
POOL_MODES = ("avg", "max")
# floats of decoded weight rows per round (csrc/conv_common.cuh CONV_WCAP)
_CONV_WCAP = 2048
# dynamic shared memory a CTA may take before a smaller band is chosen,
# and the H100's per-block maximum
_CONV_SMEM_SOFT = 48 * 1024
_CONV_SMEM_MAX = 232448


def _check_pool(pool, Ho: int, Wo: int) -> None:
    if pool is None:
        return
    mode, size = pool
    if mode not in POOL_MODES or int(size) < 1:
        raise ValueError(
            f"unknown fused pool {pool!r} — expected (mode, size) with "
            f"mode in {POOL_MODES} and size >= 1")
    if Ho % size or Wo % size:
        raise ValueError(
            f"fused pool window {size} does not tile the conv output "
            f"({Ho}x{Wo}) — the emit step pools non-overlapping windows")


def valid_out_hw(H: int, W: int, kernel_hw, strides, dilation):
    """(Ho, Wo) of a VALID conv with the given strides and dilation."""
    kh, kw = kernel_hw
    ekh = (kh - 1) * dilation[0] + 1
    ekw = (kw - 1) * dilation[1] + 1
    return (H - ekh) // strides[0] + 1, (W - ekw) // strides[1] + 1


def im2col_valid(x: torch.Tensor, kernel_hw, strides=(1, 1),
                 dilation=(1, 1)) -> torch.Tensor:
    """(B, H, W, C) padded image -> (B, Ho, Wo, C*kh*kw) patches.

    One strided slice per (dh, dw) tap, stacked and transposed into the
    channel-major patch order of the reference (f = c*kh*kw + dh*kw + dw):
    bitwise the patches of ``repro``'s ``_im2col_tile`` / ``conv_im2col``.
    """
    kh, kw = kernel_hw
    sh, sw = strides
    dl_h, dl_w = dilation
    B, H, W, C = x.shape
    Ho, Wo = valid_out_hw(H, W, kernel_hw, strides, dilation)
    taps = [x[:, dh * dl_h:dh * dl_h + sh * (Ho - 1) + 1:sh,
              dw * dl_w:dw * dl_w + sw * (Wo - 1) + 1:sw, :]
            for dh in range(kh) for dw in range(kw)]
    t = torch.stack(taps, dim=-2)            # (B, Ho, Wo, kh*kw, C)
    t = t.transpose(-1, -2)                  # (B, Ho, Wo, C, kh*kw)
    return t.reshape(B, Ho, Wo, C * kh * kw)


def pool_nhwc(y: torch.Tensor, pool) -> torch.Tensor:
    """(B, H, W, C) non-overlapping z x z window pool (VALID: a ragged
    edge is dropped).  ``avg`` sums the window, then divides by z²."""
    mode, z = pool
    B, H, W, C = y.shape
    Hp, Wp = H // z, W // z
    t = y[:, :Hp * z, :Wp * z, :].reshape(B, Hp, z, Wp, z, C)
    if mode == "max":
        return t.amax(dim=(2, 4))
    return t.sum(dim=(2, 4)) / float(z * z)


def _conv_smem(band: int, W: int, C: int, kh: int, dh: int, sh: int,
               Wo: int, bns: int) -> int:
    """Shared-memory bytes of one conv CTA (csrc/conv_common.cuh)."""
    img = ((band - 1) * sh + (kh - 1) * dh + 1) * W * C
    acc = band * Wo * bns
    return (img + acc + _CONV_WCAP) * 4 + (_CONV_WCAP // bns) * 4


def conv_geom(x: torch.Tensor, kernel_hw, strides, dilation, pool, bns: int,
              name: str):
    """The 12 geometry ints of a conv launch (kh, kw, sh, sw, dh, dw, Ho,
    Wo, z, pool_max, band, bns) and the output's (Hp, Wp).

    ``band`` is the most conv output rows (a multiple of the pool window)
    whose image rows and accumulators fit one CTA's shared memory, for the
    band route's ``bns`` columns per CTA; ``bns=0`` (the register-tiled
    route, which stages whole images) leaves it at Ho."""
    B, H, W, C = (int(d) for d in x.shape)
    kh, kw = kernel_hw
    sh, sw = strides
    dh, dw = dilation
    Ho, Wo = valid_out_hw(H, W, kernel_hw, strides, dilation)
    z = 1 if pool is None else int(pool[1])
    pool_max = int(pool is not None and pool[0] == "max")

    def smem(band):
        return _conv_smem(band, W, C, kh, dh, sh, Wo, bns)

    band = Ho
    if bns:
        while band > z and smem(band) > _CONV_SMEM_SOFT:
            band -= z
        if smem(band) > _CONV_SMEM_MAX:
            raise ValueError(
                f"{name}: one band of {band} output rows of a {H}x{W}x{C} "
                f"image needs {smem(band)} bytes of shared memory, more "
                f"than a CTA's {_CONV_SMEM_MAX}")
    geom = (kh, kw, sh, sw, dh, dw, Ho, Wo, z, pool_max, band, bns)
    return geom, Ho // z, Wo // z


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """The register-tiled conv kernel's split of one launch
    (``csrc/conv_reg.cuh``).

    A thread owns one *unit* of one image: a z x z pooled window (z = 2)
    or :data:`REG_STRIP` consecutive conv positions of a row (z = 1, the
    last unit of a row masked past Wo), times ``ct`` output columns, over
    one of ``ks`` parts of the K walk: :data:`REG_POS` x ``ct`` f32
    accumulators in registers.  CTA ``(bx, by)`` covers images ``bx * img``
    onward and column tile ``by`` (block-sparse: column block
    ``by // (bn // ct)``, its ``by % (bn // ct)``-th slice of ``ct``
    columns; quant: columns ``by * ct`` onward, the last tile masked past
    N).  Thread ``t`` is K part ``t // part``, slot ``u = t % part``:
    image ``u // units``, unit ``u % units`` (row ``// upr``, column
    ``% upr``); slots past ``img * units`` idle.  Part ``kp`` walks steps
    ``[kp * per * unit, (kp + 1) * per * unit)`` of the CTA's walk (quant:
    k rows, ``unit`` 1; block-sparse: the column block's present blocks in
    row order, ``unit`` = bk rows each), and part 0 adds the other parts'
    accumulators in part order, then emits."""
    z: int          # pool window (1: no pool)
    ct: int         # columns per thread (a kernel template value)
    n_ct: int       # column tiles: grid.y
    upr: int        # units per row of units
    units: int      # units per image
    img: int        # images per CTA
    part: int       # threads per K part: img * units rounded up to a warp
    ks: int         # K parts
    per: int        # k rows (quant) or blocks (block-sparse) per part
    steps: int      # walk steps a CTA stages, at most (K, or blocks * bk)
    grid: tuple     # (ceil(B / img), n_ct)
    threads: int    # ks * part
    smem: int       # dynamic shared-memory bytes

    def ints(self):
        """The plan as the kernels' int array (``rt::RegPlan``)."""
        return (self.ct, self.n_ct, self.upr, self.units, self.img,
                self.part, self.ks, self.per, self.steps)


# Columns per thread of the register-tiled kernels.  On the H100 a tile of
# 4 beat 8 at LeNet's quant convs (twice the CTAs, more warps an SM to hide
# shared-memory latency), and sixteen warps an SM beat eight at conv2
# (PERF.md).
REG_TILES = (2, 4)
REG_POS = 4                # conv positions per thread (csrc/conv_reg.cuh)
REG_STRIP = 4              # unpooled positions per unit, along a row
REG_SMS = 132              # SMs of an H100
REG_TARGET = 132 * 16 * 32  # threads a grid aims for: sixteen warps an SM
REG_MIN_STEPS = 16         # k rows per K part, at least
REG_MAX_THREADS = 512      # threads per CTA, at most (__launch_bounds__)
REG_SMEM_MAX = 48 * 1024   # dynamic shared memory of a CTA, at most


def _reg_smem(img: int, hwc: int, steps: int, ct: int, ks: int,
              part: int) -> int:
    """Shared-memory bytes of one register-tiled CTA: its images (f32,
    channel-major, an odd number of floats apart when there are several,
    padded to whole 16-byte rows), the walk's decoded weight rows and
    patch offsets, the tile's emit scales and biases, and the K parts'
    accumulators for part 0 to add."""
    stride = hwc + 1 if img > 1 and hwc % 2 == 0 else hwc
    img_f = -(-img * stride // 4) * 4
    return 4 * (img_f + steps * ct + 2 * ct
                + (ks - 1) * REG_POS * ct * part + steps)


def conv_route(B: int, H: int, W: int, C: int, kernel_hw, strides, dilation,
               pool, N: int, x_dtype, block=None,
               max_blocks_per_col: int = 0):
    """``(route, plan)`` of a fused conv, as a shape rule.

    ``("reg_tile", ConvPlan)`` when x is f32 or bf16, the pool window z is
    1 or 2 (no pool, or 2 x 2), the column tile fits — quant (``block``
    None): ``ct`` the smallest of :data:`REG_TILES` that holds N, else the
    largest; block-sparse (``block=(bk, bn)``): the largest that divides
    bn, so a thread's columns lie in one column block, whose walk is
    uniform across the CTA — and one image's units and a CTA's shared
    memory fit; ``("band", None)``, the first design, otherwise (odd bn,
    3 x 3 and larger pools, large images).

    The plan fills a warp with whole images (``img``: the smallest power
    of two with ``img * units >= 32``, halved while the grid has fewer
    CTAs than :data:`REG_SMS`), then splits K into the fewest parts that
    bring the grid's threads to :data:`REG_TARGET`, each of at least
    :data:`REG_MIN_STEPS` k rows (block-sparse: whole blocks) and at most
    :data:`REG_MAX_THREADS` threads a CTA."""
    kh, kw = (int(k) for k in kernel_hw)
    Ho, Wo = valid_out_hw(H, W, (kh, kw), strides, dilation)
    z = 1 if pool is None else int(pool[1])
    if x_dtype not in X_DTYPES or z not in (1, 2):
        return "band", None
    K = C * kh * kw
    if block is None:
        ct = next((t for t in REG_TILES if t >= N), REG_TILES[-1])
        n_ct, unit, walk = -(-N // ct), 1, K
    else:
        bk, bn = (int(d) for d in block)
        ct = next((t for t in reversed(REG_TILES) if bn % t == 0), None)
        if ct is None:
            return "band", None
        n_ct, unit, walk = N // ct, bk, max(int(max_blocks_per_col), 1)
    if z == 2:
        upr, units = Wo // 2, (Ho // 2) * (Wo // 2)
    else:
        upr = -(-Wo // REG_STRIP)
        units = Ho * upr
    img = 1
    while img * units < 32 and img < B:
        img *= 2
    while img > 1 and -(-B // img) * n_ct < REG_SMS:
        img //= 2
    part = -(-img * units // 32) * 32
    if part > REG_MAX_THREADS:
        return "band", None
    base = -(-B // img) * n_ct * part
    ks_max = max(1, walk // -(-REG_MIN_STEPS // unit))
    ks = max(1, min(-(-REG_TARGET // base), ks_max, REG_MAX_THREADS // part))
    per = -(-walk // ks)
    ks = -(-walk // per)
    steps = walk * unit
    smem = _reg_smem(img, H * W * C, steps, ct, ks, part)
    if smem > REG_SMEM_MAX:
        return "band", None
    return "reg_tile", ConvPlan(z, ct, n_ct, upr, units, img, part, ks, per,
                                steps, (-(-B // img), n_ct), ks * part, smem)


def check_conv_input(x: torch.Tensor, kernel_hw, strides, dilation, pool,
                     name: str):
    """Validate an NHWC conv input; returns (Ho, Wo)."""
    if x.ndim != 4:
        raise ValueError(f"{name} expects NHWC input, got shape "
                         f"{tuple(x.shape)}")
    H, W = int(x.shape[1]), int(x.shape[2])
    Ho, Wo = valid_out_hw(H, W, kernel_hw, strides, dilation)
    if Ho < 1 or Wo < 1:
        raise ValueError(
            f"{name}: conv kernel {tuple(kernel_hw)} does not fit the "
            f"{H}x{W} input")
    _check_pool(pool, Ho, Wo)
    return Ho, Wo


def epilogue_of_zero(N: int, bias, activation, device) -> torch.Tensor:
    """act(0 + b) per output channel: the output of a column with no block."""
    v = torch.zeros((N,), dtype=torch.float32, device=device)
    if bias is not None:
        v = v + bias.reshape(N).to(torch.float32)
    return apply_activation(v, activation)


def _conv_lib():
    fn = build.library("block_sparse_conv").bsc_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, P, P, I, I, I, P, P, P, P, P, I, P,
                       I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _conv_reg_lib():
    fn = build.library("block_sparse_conv").bsc_reg_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, P, P, P, I, I, I, P, P, P, P, P, I,
                       P, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def block_sparse_conv(
    x: torch.Tensor,
    blocks: torch.Tensor,
    schedule: Schedule,
    *,
    kernel_hw,
    scales: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    strides=(1, 1),
    dilation=(1, 1),
    pool=None,
    packed=False,
    name: str = "block_sparse_conv",
) -> torch.Tensor:
    """y = pool(act(conv(x, W) + b)) in one launch, in x's dtype.

    ``x`` is NHWC and already padded (VALID geometry; SAME resolves to a
    zero-pad upstream).  W is the block-compacted im2col weight: ``blocks``
    ``(P, bk, bn)`` f32, bf16 or int8 codes with per-channel ``scales``,
    or with ``packed`` "int4x2"/"int2x4" the uint8 container
    ``(P, bk / ratio, bn)`` packed along bk.  The patches are gathered
    inside the kernel: no patch matrix exists.  ``pool=(mode, z)`` pools
    non-overlapping windows at emit ("avg": sum, then / z²; "max"); the
    output is then ``(B, Ho / z, Wo / z, N)``.  A column block with no
    present block emits ``act(b)``; a fully empty pattern launches nothing.
    """
    global conv_launches, conv_launches_reg, conv_launches_band
    refuse_dtensor(name, x, blocks, scales, bias)
    _check_activation(activation)
    strides = (int(strides[0]), int(strides[1]))
    dilation = (int(dilation[0]), int(dilation[1]))
    kh, kw = (int(k) for k in kernel_hw)
    Ho, Wo = check_conv_input(x, (kh, kw), strides, dilation, pool, name)
    ratio = packed_ratio(packed)
    P, bkp, bn = (int(d) for d in blocks.shape)
    bk = bkp * ratio
    B, H, W, C = (int(d) for d in x.shape)
    if C * kh * kw != schedule.n_row_blocks * bk:
        raise ValueError(
            f"{name}: im2col K={C * kh * kw} (cin*kh*kw) != "
            f"n_row_blocks*bk={schedule.n_row_blocks * bk}")
    N = schedule.n_col_blocks * bn
    z = 1 if pool is None else int(pool[1])
    if P == 0:
        # fully empty pattern: one epilogue application; pooling a constant
        # returns it, so nothing is launched
        v = epilogue_of_zero(N, bias, activation, x.device)
        return v.to(x.dtype).expand(B, Ho // z, Wo // z, N).contiguous()
    if not x.is_cuda:
        from .ref import block_sparse_conv_ref
        from ...core.quant import unpack_codes
        vals = unpack_codes(blocks, bk, axis=1, bits=8 // ratio) \
            if ratio > 1 else blocks
        return block_sparse_conv_ref(
            x, vals, schedule.block_rows, schedule.block_cols,
            kernel_hw=(kh, kw), n_row_blocks=schedule.n_row_blocks,
            n_col_blocks=schedule.n_col_blocks, scales=scales, bias=bias,
            activation=activation, strides=strides, dilation=dilation,
            pool=pool, out_dtype=x.dtype)
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    w_kind(blocks, ratio, name)
    dev = x.device
    check_cuda_operand(x, dev, "x", name)
    check_cuda_operand(blocks, dev, "blocks", name)
    check_cuda_operand(schedule.col_ptr, dev, "the schedule", name)
    if P != int(schedule.rows.numel()):
        raise ValueError(
            f"{name}: {P} blocks but the schedule lists "
            f"{int(schedule.rows.numel())}")
    route, plan = conv_route(B, H, W, C, (kh, kw), strides, dilation, pool,
                             N, x.dtype, block=(bk, bn),
                             max_blocks_per_col=schedule.max_blocks_per_col)
    out = _conv_launch(x, blocks, schedule, (kh, kw), scales, bias,
                       activation, strides, dilation, pool, ratio, route,
                       plan, name)
    conv_launches += 1
    if route == "reg_tile":
        conv_launches_reg += 1
    else:
        conv_launches_band += 1
    return out


def _conv_launch(x, blocks, schedule: Schedule, kernel_hw, scales, bias,
                 activation, strides, dilation, pool, ratio: int, route: str,
                 plan: Optional[ConvPlan] = None,
                 name: str = "block_sparse_conv") -> torch.Tensor:
    """Launch ``route``'s conv kernel ("reg_tile" with its ``plan``, or
    "band", the first design) on CUDA operands that passed
    :func:`block_sparse_conv`'s checks; counts nothing (the wrapper
    counts).  Either route may be asked for, to time one beside the
    other."""
    B, H, W, C = (int(d) for d in x.shape)
    bn = int(blocks.shape[2])
    bk = int(blocks.shape[1]) * ratio
    N = schedule.n_col_blocks * bn
    code, tau = act_args(activation)
    kind = w_kind(blocks, ratio, name)
    dev = x.device
    reg = route == "reg_tile"
    if not reg and route != "band":
        raise ValueError(f"{name}: unknown conv route {route!r}")
    geom, Hp, Wp = conv_geom(x, kernel_hw, strides, dilation, pool,
                             0 if reg else min(bn, 32), name)
    s = vec_f32(scales, N, dev, "scales", name)
    b = vec_f32(bias, N, dev, "bias", name)
    out = torch.empty((B, Hp, Wp, N), dtype=x.dtype, device=dev)
    g = (ctypes.c_int * 12)(*geom)
    args = (ptr(blocks), kind, bk, bn, ptr(s), ptr(b), ptr(schedule.col_ptr),
            ptr(schedule.rows), ptr(schedule.pidx), schedule.n_col_blocks,
            ptr(out), code, tau, torch.cuda.current_stream(dev).cuda_stream)
    x_bf16 = int(x.dtype == torch.bfloat16)
    if reg:
        pl = (ctypes.c_int * 9)(*plan.ints())
        err = _conv_reg_lib()(ptr(x), x_bf16, B, H, W, C, g, pl, *args)
    else:
        err = _conv_lib()(ptr(x), x_bf16, B, H, W, C, g, *args)
    build.check(err, name)
    return out
