"""Quantised dense matmul and conv — the wrappers of the CUDA kernels.

``y = act((x @ Wq) * s + b)`` with int8 codes or bit-packed int4x2 / int2x4
codes along K; the scale multiplies the f32 accumulator at emit.  The
kernels of ``csrc/quant_matmul.cu`` replace the Pallas ``quant_matmul`` of
``repro.kernels.quant_matmul.kernel``; their plain PyTorch version is
:func:`repro_torch.kernels.quant_matmul.ref.quant_matmul_ref`.
:func:`qmm_route` picks the route from the shapes: the thin-M kernel
(:func:`qmm_plan`: K split across CTAs, a deterministic second pass) for
decode rows, M <= 16; the tensor-core kernel (:func:`qmm_tc_plan`: wgmma
tiles, K split when the tiles alone are far from one wave of the card) for
bf16 rows past 16 at aligned widths; the tiled kernel, the first design on
the CUDA cores, for the rest.  :func:`quant_conv` is the fused conv over the
same codes (``csrc/quant_conv.cu``, plain version ``quant_conv_ref``); the
shape rule ``conv_route`` of the block-sparse module picks its route, the
register-tiled kernel or the band kernel (the first design).

A wrapper launches the kernel for CUDA tensors and takes the plain version
for CPU tensors, and only then.  ``launches`` counts calls of the matmul
kernels (``launches_thin``, ``launches_tc`` and ``launches_tiled`` those of
each route), ``conv_launches`` those of the conv kernels
(``conv_launches_reg`` and ``conv_launches_band`` those of each route).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import build, refuse_dtensor
from ..sparse_matmul.kernel import (
    TC_COLS,
    TC_K_STEP,
    TC_MIN_STEPS,
    X_DTYPES,
    _check_activation,
    _int_plan,
    act_args,
    check_conv_input,
    check_cuda_operand,
    conv_geom,
    conv_route,
    packed_ratio,
    ptr,
    rows_per_cta,
    tc_cuts,
    tc_m_tile,
    vec_f32,
    w_kind,
)

__all__ = ["QmmPlan", "QmmTcPlan", "conv_launches", "conv_launches_band",
           "conv_launches_reg", "launches", "launches_tc", "launches_thin",
           "launches_tiled", "qmm_candidates", "qmm_plan", "qmm_plan_error",
           "qmm_route", "qmm_tc_plan", "quant_conv", "quant_matmul",
           "tuned_hits", "tuned_misses"]

# kernel launches since the counters were last set to 0
launches = 0         # quant_matmul, every route
launches_thin = 0    # quant_matmul, thin-M route
launches_tc = 0      # quant_matmul, tensor-core route
launches_tiled = 0   # quant_matmul, tiled route
conv_launches = 0    # quant_conv, every route
conv_launches_reg = 0   # quant_conv, register-tiled route
conv_launches_band = 0  # quant_conv, band route
# quant_matmul launches given a tuned plan: on it, or (the plan illegal for
# the call) on the shape rule's route and plan instead
tuned_hits = 0
tuned_misses = 0

THIN_M_MAX = 16      # rows of the thin-M route (decode batches)
THIN_COLS = 128      # output columns per CTA of the thin-M kernel
THIN_KCAP = 512      # codes of K per split, at most (the kernel's x stage)
THIN_MIN_ROWS = 8    # byte rows per split, at least: two per warp
CTA_TARGET = 2 * 132  # CTAs the thin-M route aims for: two per H100 SM
TC_N_ALIGN = 8       # N of the tensor-core route: the codes' row pitch in
                     # whole 8-byte pieces (1-byte containers); TMA copies
                     # rows of whole 16 bytes, cp.async those of N % 16 == 8


class QmmPlan(NamedTuple):
    """The thin-M kernel's grid: ``cols_per_cta`` output columns by
    ``k_splits`` ranges of ``rows_per_split`` whole byte rows of the
    container (the last range may be shorter)."""
    cols_per_cta: int
    k_splits: int
    rows_per_split: int


def qmm_plan(M: int, K: int, N: int, ratio: int, w_ptr: int = 0,
             cta_target: int = CTA_TARGET) -> Optional[QmmPlan]:
    """The route of a quant matmul, as a shape rule: the thin-M plan when
    ``M <= THIN_M_MAX``, ``N % 4 == 0`` and the container's address
    ``w_ptr`` is 4-byte aligned (each lane loads 4 bytes of a byte row);
    ``None`` — the tiled kernel — otherwise.

    The plan cuts the ``K / ratio`` byte rows into splits of whole rows, at
    most :data:`THIN_KCAP` codes each, and enough of them that the grid of
    ``ceil(N / THIN_COLS)`` column tiles times the splits reaches
    ``cta_target`` CTAs (:data:`CTA_TARGET` by default), unless that would
    leave fewer than :data:`THIN_MIN_ROWS` rows to a split."""
    if M > THIN_M_MAX or N % 4 or w_ptr % 4:
        return None
    rows = K // ratio
    want = -(-cta_target // -(-N // THIN_COLS))
    per = min(max(rows // want, THIN_MIN_ROWS), THIN_KCAP // ratio, rows)
    return QmmPlan(THIN_COLS, -(-rows // per), per)


class QmmTcPlan(NamedTuple):
    """The tensor-core kernel's grid: ``m_tile`` rows (64 or 128) by
    ``n_tile`` columns per CTA, by ``k_splits`` ranges of ``steps_per_split``
    steps of :data:`TC_K_STEP` codes (the last range may be shorter)."""
    m_tile: int
    n_tile: int
    k_splits: int
    steps_per_split: int


def qmm_tc_plan(M: int, K: int, N: int, m_tile: Optional[int] = None,
                cuts: Optional[int] = None) -> QmmTcPlan:
    """The tensor-core kernel's tiles and K splits: the K / :data:`TC_K_STEP`
    steps cut into :func:`tc_cuts` even splits (none when the ``ceil(M /
    m_tile) * ceil(N / TC_COLS)`` tiles alone reach about one wave of the
    card; the last column tile may be ragged),
    each of at least :data:`TC_MIN_STEPS` steps when K has that many;
    ``m_tile`` (64 or 128) by :func:`tc_m_tile` and the cuts by
    :func:`tc_cuts` unless given."""
    steps = K // TC_K_STEP
    n_tiles = -(-N // TC_COLS)

    def plan(m):
        c = tc_cuts(-(-M // m) * n_tiles) if cuts is None else cuts
        splits = min(c, max(steps // TC_MIN_STEPS, 1))
        per = -(-steps // splits)
        return QmmTcPlan(m, TC_COLS, -(-steps // per), per)

    if m_tile is None:
        m_tile = tc_m_tile(M, n_tiles, plan(128).steps_per_split)
    return plan(m_tile)


def qmm_route(M: int, K: int, N: int, ratio: int, x_bf16: bool,
              w_ptr: int = 0, x_ptr: int = 0):
    """``(route, plan)`` of a quant matmul, as a shape rule.

    ``("thin_m", QmmPlan)`` when :func:`qmm_plan` gives a plan (M <= 16);
    else ``("tensor_core", QmmTcPlan)`` when x is bf16, ``K`` is a multiple
    of :data:`TC_K_STEP` (whole steps, and x rows in 16-byte copies), ``N``
    a multiple of :data:`TC_N_ALIGN` (the codes' row pitch in whole 8-byte
    pieces: TMA reads a pitch of whole 16 bytes, cp.async one of N % 16 ==
    8; the last of the ``ceil(N / TC_COLS)`` column tiles may be ragged),
    ``x_ptr`` is 16-byte aligned and ``w_ptr`` 16-byte aligned (8-byte when
    N % 16 == 8); else ``("tiled", None)``, the CUDA-core kernel (f32 x,
    odd widths).  Every container is 1-byte (int8, int4x2, int2x4), which
    the tensor-core kernel takes."""
    plan = qmm_plan(M, K, N, ratio, w_ptr)
    if plan is not None:
        return "thin_m", plan
    if _qmm_tc_error(M, K, N, x_bf16, w_ptr, x_ptr) is None:
        return "tensor_core", qmm_tc_plan(M, K, N)
    return "tiled", None


def _qmm_tc_error(M, K, N, x_bf16, w_ptr, x_ptr) -> Optional[str]:
    """Why the tensor-core route cannot take these operands, or None."""
    if not x_bf16:
        return "the tensor-core route needs bf16 x"
    if M <= THIN_M_MAX:
        return f"the tensor-core route needs M > {THIN_M_MAX}, got {M}"
    if K % TC_K_STEP or N % TC_N_ALIGN:
        return (f"the tensor-core route needs K % {TC_K_STEP} == 0 and "
                f"N % {TC_N_ALIGN} == 0, got K={K}, N={N}")
    if x_ptr % 16 or w_ptr % (16 if N % 16 == 0 else 8):
        return ("the tensor-core route needs 16-byte aligned x and codes "
                "(8-byte aligned codes when N % 16 == 8)")
    return None


def qmm_plan_error(route: str, plan, M: int, K: int, N: int, ratio: int,
                   x_bf16: bool, w_ptr: int = 0,
                   x_ptr: int = 0) -> Optional[str]:
    """Why ``route`` with ``plan`` (a :class:`QmmPlan` / :class:`QmmTcPlan`
    or its tuple of ints; None for "tiled") cannot take the quant matmul of
    these operands (the arguments of :func:`qmm_route`), or None when it
    can.  Pure: the wrapper's check of a given plan."""
    if route == "tiled":
        return None if plan is None else "the tiled route takes no plan"
    if route == "thin_m":
        if qmm_plan(M, K, N, ratio, w_ptr) is None:
            return (f"the thin-M route needs M <= {THIN_M_MAX}, N % 4 == 0 "
                    f"and 4-byte aligned codes, got M={M}, N={N}")
        t = _int_plan(plan, 3, "the thin-M route")
        if isinstance(t, str):
            return t
        cols, splits, per = t
        rows = K // ratio
        if cols != THIN_COLS or not 1 <= per <= min(rows, THIN_KCAP // ratio) \
                or splits != -(-rows // per):
            return (f"plan {t}: {THIN_COLS} columns a CTA and splits of 1 "
                    f"to {min(rows, THIN_KCAP // ratio)} byte rows must "
                    f"cover {rows} rows")
        return None
    if route == "tensor_core":
        err = _qmm_tc_error(M, K, N, x_bf16, w_ptr, x_ptr)
        if err is not None:
            return err
        t = _int_plan(plan, 4, "the tensor-core route")
        if isinstance(t, str):
            return t
        m_tile, n_tile, splits, per = t
        steps = K // TC_K_STEP
        if m_tile not in (64, 128) or n_tile != TC_COLS:
            return f"tiles {m_tile} x {n_tile}, not 64/128 x {TC_COLS}"
        if not min(TC_MIN_STEPS, steps) <= per <= steps \
                or splits != -(-steps // per):
            return (f"{splits} splits of {per} steps: splits of at least "
                    f"{min(TC_MIN_STEPS, steps)} steps must cover {steps}")
        return None
    return f"unknown route {route!r}"


def qmm_candidates(M: int, K: int, N: int, ratio: int, x_bf16: bool,
                   w_ptr: int = 0, x_ptr: int = 0):
    """``(route, plan)`` candidates of a quant matmul for the autotuner,
    the rule's own (:func:`qmm_route`) first: the thin-M plan with
    :data:`CTA_TARGET` halved and doubled; the tensor-core plans with 64-
    and 128-row tiles crossed with 1, :func:`tc_cuts` and twice that many
    K splits; the tiled route, always legal.  Every one passes
    :func:`qmm_plan_error`."""
    args = (M, K, N, ratio, x_bf16, w_ptr, x_ptr)
    out = [qmm_route(*args)]

    def add(route, plan):
        if (route, plan) not in out and not qmm_plan_error(route, plan, *args):
            out.append((route, plan))

    if out[0][0] == "thin_m":
        for target in (CTA_TARGET // 2, CTA_TARGET * 2):
            add("thin_m", qmm_plan(M, K, N, ratio, w_ptr, target))
    elif _qmm_tc_error(M, K, N, x_bf16, w_ptr, x_ptr) is None:
        for m in (64, 128):
            c = tc_cuts(-(-M // m) * -(-N // TC_COLS))
            for cuts in (1, c, 2 * c):
                add("tensor_core", qmm_tc_plan(M, K, N, m_tile=m, cuts=cuts))
    add("tiled", None)
    return out


def _lib():
    fn = build.library("quant_matmul").qmm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, I, I, P, P, P, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _thin_lib():
    fn = build.library("quant_matmul").qmm_thin_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, I, I, I, I, P, P, P, P, I, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _tc_lib():
    fn = build.library("quant_matmul").qmm_tc_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, I, I, I, I, I, P, P, P, P, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def quant_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scales: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation=None,
    packed=False,
    name: str = "quant_matmul",
    plan=None,
    tuned: bool = False,
) -> torch.Tensor:
    """y = act(x @ dequant(W) + b), in x's dtype.

    ``w_q`` is ``(K, N)`` int8, or with ``packed`` "int4x2"/"int2x4" the
    uint8 container ``(K / ratio, N)`` packed along K (K divisible by the
    ratio).  ``name`` labels errors (the dispatch passes the leaf name).

    ``plan``: a ``(route, plan)`` pair (:func:`qmm_candidates`) to launch
    instead of the shape rule's; one the call cannot take
    (:func:`qmm_plan_error`) raises — unless ``tuned`` (it came from a
    tuned table), when the rule's route and plan run instead, counted in
    ``tuned_misses``; a tuned plan that runs counts in ``tuned_hits``.
    """
    global launches, launches_thin, launches_tc, launches_tiled, \
        tuned_hits, tuned_misses
    refuse_dtensor(name, x, w_q, scales, bias)
    ratio = packed_ratio(packed)
    M, K = x.shape
    N = int(w_q.shape[1])
    if packed and K % ratio:
        raise ValueError(
            f"{name}: a {packed} container needs K divisible by {ratio}, "
            f"got K={K}")
    if int(w_q.shape[0]) * ratio != K:
        raise ValueError(
            f"{name}: weight rows {int(w_q.shape[0])} x {ratio} codes/byte "
            f"!= K={K}")
    shape = (M, K, N, ratio, x.dtype == torch.bfloat16, w_q.data_ptr(),
             x.data_ptr())
    err = None if plan is None else qmm_plan_error(plan[0], plan[1], *shape)
    if err is not None and not tuned:
        from .. import check_plan
        check_plan("quant_matmul", plan[0], plan[1], shape, name=name)
    if not x.is_cuda:
        from .ref import quant_matmul_ref
        from ...core.quant import unpack_codes
        codes = unpack_codes(w_q, K, axis=0, bits=8 // ratio) \
            if ratio > 1 else w_q
        return quant_matmul_ref(x, codes, scales, bias=bias,
                                activation=activation, out_dtype=x.dtype)
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if M < 1:
        raise ValueError(f"{name}: needs at least one row, got M={M}")
    if plan is None or err is not None:
        if err is not None:
            tuned_misses += 1
        route, plan = qmm_route(*shape)
    else:
        tuned_hits += int(tuned)
        route = plan[0]
        plan = None if route == "tiled" else \
            (QmmPlan if route == "thin_m" else QmmTcPlan)(*plan[1])
    out = _launch(x, w_q, scales, bias, activation, ratio, route, plan, name)
    launches += 1
    if route == "thin_m":
        launches_thin += 1
    elif route == "tensor_core":
        launches_tc += 1
    else:
        launches_tiled += 1
    return out


def _launch(x, w_q, scales, bias, activation, ratio: int, route: str,
            plan=None, name: str = "quant_matmul", ws=None) -> torch.Tensor:
    """Launch ``route``'s kernel ("thin_m" or "tensor_core" with its
    ``plan``, or "tiled") on CUDA operands; counts nothing (the wrapper
    counts).  Any route may be asked for, to time one beside another.
    ``ws``: the (k_splits, M, N) f32 workspace of a split plan, kept by the
    caller to read the partials (else one is allocated)."""
    M, K = x.shape
    N = int(w_q.shape[1])
    code, tau = act_args(activation)
    kind = w_kind(w_q, ratio, name)
    if kind not in (2, 3, 4):
        raise ValueError(
            f"{name}: the quant kernel takes int8 or packed uint8 codes, got "
            f"{w_q.dtype}")
    dev = x.device
    check_cuda_operand(x, dev, "x", name)
    check_cuda_operand(w_q, dev, "w_q", name)
    s = vec_f32(scales, N, dev, "scales", name)
    b = vec_f32(bias, N, dev, "bias", name)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x_bf16 = int(x.dtype == torch.bfloat16)
    if route == "tiled":
        err = _lib()(ptr(x), x_bf16, M, K, ptr(w_q), kind, N, ptr(s), ptr(b),
                     ptr(out), rows_per_cta(M), code, tau, stream)
    elif route in ("thin_m", "tensor_core"):
        if ws is None and plan.k_splits > 1:
            ws = torch.empty((plan.k_splits, M, N), dtype=torch.float32,
                             device=dev)
        if route == "thin_m":
            err = _thin_lib()(ptr(x), x_bf16, M, K, ptr(w_q), kind, N,
                              plan.k_splits, plan.rows_per_split, ptr(s),
                              ptr(b), ptr(ws), ptr(out), rows_per_cta(M),
                              code, tau, stream)
        else:
            err = _tc_lib()(ptr(x), M, K, ptr(w_q), kind, N, plan.m_tile,
                            plan.k_splits, plan.steps_per_split, ptr(s),
                            ptr(b), ptr(ws), ptr(out), code, tau, stream)
    else:
        raise ValueError(f"{name}: unknown route {route!r}")
    build.check(err, name)
    return out


def _conv_lib():
    fn = build.library("quant_conv").qconv_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, P, P, I, I, I, P, P, P, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _conv_reg_lib():
    fn = build.library("quant_conv").qconv_reg_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, P, P, P, I, I, I, P, P, P, I,
                       ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def quant_conv(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scales: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    kernel_hw,
    activation=None,
    strides=(1, 1),
    dilation=(1, 1),
    pool=None,
    packed=False,
    name: str = "quant_conv",
) -> torch.Tensor:
    """y = pool(act(conv(x, Wq) * s + b)) in one launch, in x's dtype.

    ``x`` is NHWC and already padded (VALID geometry).  ``w_q`` is the
    ``(K, N)`` int8 im2col code matrix (K = cin*kh*kw, channel-major), or
    with ``packed`` "int4x2"/"int2x4" its uint8 container ``(K / ratio, N)``
    packed along K.  The scale multiplies the f32 accumulator at emit.
    ``pool=(mode, z)`` pools non-overlapping windows at emit.
    """
    global conv_launches, conv_launches_reg, conv_launches_band
    refuse_dtensor(name, x, w_q, scales, bias)
    _check_activation(activation)
    strides = (int(strides[0]), int(strides[1]))
    dilation = (int(dilation[0]), int(dilation[1]))
    kh, kw = (int(k) for k in kernel_hw)
    check_conv_input(x, (kh, kw), strides, dilation, pool, name)
    B, H, W, C = (int(d) for d in x.shape)
    K = C * kh * kw
    ratio = packed_ratio(packed)
    N = int(w_q.shape[1])
    if packed and K % ratio:
        raise ValueError(
            f"{name}: a {packed} container needs K divisible by {ratio}, "
            f"got K={K}")
    if int(w_q.shape[0]) * ratio != K:
        raise ValueError(
            f"{name}: im2col K={K} (cin*kh*kw) != weight rows "
            f"{int(w_q.shape[0])} x {ratio} codes/byte")
    if not x.is_cuda:
        from .ref import quant_conv_ref
        from ...core.quant import unpack_codes
        codes = unpack_codes(w_q, K, axis=0, bits=8 // ratio) \
            if ratio > 1 else w_q
        return quant_conv_ref(x, codes, scales, bias, kernel_hw=(kh, kw),
                              activation=activation, strides=strides,
                              dilation=dilation, pool=pool, out_dtype=x.dtype)
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if w_kind(w_q, ratio, name) not in (2, 3, 4):
        raise ValueError(
            f"{name}: the quant kernel takes int8 or packed uint8 codes, got "
            f"{w_q.dtype}")
    dev = x.device
    check_cuda_operand(x, dev, "x", name)
    check_cuda_operand(w_q, dev, "w_q", name)
    route, plan = conv_route(B, H, W, C, (kh, kw), strides, dilation, pool,
                             N, x.dtype)
    out = _conv_launch(x, w_q, scales, bias, (kh, kw), activation, strides,
                       dilation, pool, ratio, route, plan, name)
    conv_launches += 1
    if route == "reg_tile":
        conv_launches_reg += 1
    else:
        conv_launches_band += 1
    return out


def _conv_launch(x, w_q, scales, bias, kernel_hw, activation, strides,
                 dilation, pool, ratio: int, route: str, plan=None,
                 name: str = "quant_conv") -> torch.Tensor:
    """Launch ``route``'s conv kernel ("reg_tile" with its ``plan``, or
    "band", the first design) on CUDA operands that passed
    :func:`quant_conv`'s checks; counts nothing (the wrapper counts).
    Either route may be asked for, to time one beside the other."""
    B, H, W, C = (int(d) for d in x.shape)
    K = C * int(kernel_hw[0]) * int(kernel_hw[1])
    N = int(w_q.shape[1])
    code, tau = act_args(activation)
    kind = w_kind(w_q, ratio, name)
    dev = x.device
    reg = route == "reg_tile"
    if not reg and route != "band":
        raise ValueError(f"{name}: unknown conv route {route!r}")
    geom, Hp, Wp = conv_geom(x, kernel_hw, strides, dilation, pool,
                             0 if reg else min(N, 32), name)
    s = vec_f32(scales, N, dev, "scales", name)
    b = vec_f32(bias, N, dev, "bias", name)
    out = torch.empty((B, Hp, Wp, N), dtype=x.dtype, device=dev)
    g = (ctypes.c_int * 12)(*geom)
    args = (ptr(w_q), kind, K, N, ptr(s), ptr(b), ptr(out), code, tau,
            torch.cuda.current_stream(dev).cuda_stream)
    x_bf16 = int(x.dtype == torch.bfloat16)
    if reg:
        pl = (ctypes.c_int * 9)(*plan.ints())
        err = _conv_reg_lib()(ptr(x), x_bf16, B, H, W, C, g, pl, *args)
    else:
        err = _conv_lib()(ptr(x), x_bf16, B, H, W, C, g, *args)
    build.check(err, name)
    return out
