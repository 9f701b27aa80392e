"""Fused FC stack — the wrapper of the CUDA kernels.

``y = actL(... act1(x @ W1 + b1) ... @ WL + bL)`` in one launch: adjacent
linears (LeNet's fc1 -> fc2 -> fc3) share a row tile whose intermediate
activations never leave the chip.  The weights arrive dense f32 (the
dispatch densifies whatever container a layer compiled to).  The kernels
(``csrc/fc_stack.cu``) replace the Pallas kernel of
``repro.kernels.fc_stack``; their plain PyTorch version is
:func:`fc_stack_matmul_ref`.

:func:`fcs_route` picks the route from the shapes: ``"staged"``
(:class:`FcsPlan`: a CTA owns a row tile and stages every layer's
weights in shared memory once; K split into parts by K alone and the
parts added in part order) where the plan fits shared memory, else
``"stream"``, the first design (weights read from global memory inside the
K walk).

The wrapper launches a kernel for CUDA tensors and takes the plain version
for CPU tensors, and only then.  ``launches`` counts kernel launches,
``launches_staged`` and ``launches_stream`` those of each route.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build, refuse_dtensor
from .sparse_matmul.kernel import (
    X_DTYPES,
    _check_activation,
    act_args,
    apply_activation,
    check_cuda_operand,
    ptr,
    vec_f32,
)

__all__ = ["FcsPlan", "fc_stack_matmul", "fc_stack_matmul_ref", "fcs_plan",
           "fcs_route", "k_split", "launches", "launches_staged",
           "launches_stream"]

# kernel launches since the counters were last set to 0
launches = 0          # every route
launches_staged = 0   # staged route
launches_stream = 0   # stream route (the first design)

MAX_LAYERS = 8                   # csrc/fc_stack.cu MAXL
_SMEM_MAX = 232448               # the H100's per-block shared memory, static
                                 # and dynamic together


def _check(x: torch.Tensor, weights, biases, activations):
    if not weights or not (len(weights) == len(biases) == len(activations)):
        raise ValueError(
            f"fc_stack_matmul needs matching non-empty weights/biases/"
            f"activations, got lengths {len(weights)}/{len(biases)}/"
            f"{len(activations)}")
    for act in activations:
        _check_activation(act)
    dims = [tuple(int(d) for d in w.shape) for w in weights]
    for (_, n_prev), (k_next, _) in zip(dims, dims[1:]):
        if n_prev != k_next:
            raise ValueError(
                f"fc_stack_matmul chain mismatch: layer output {n_prev} "
                f"feeds layer input {k_next}")
    if x.shape[-1] != dims[0][0]:
        raise ValueError(
            f"fc_stack_matmul: activation feature dim {x.shape[-1]} does not "
            f"match the first layer's K={dims[0][0]}")
    return [dims[0][0]] + [n for _, n in dims]


def fc_stack_matmul_ref(x, weights, biases, activations,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Layer by layer in f32: ``h = act(h @ W + b)``."""
    h = x.to(torch.float32)
    for w, b, act in zip(weights, biases, activations):
        h = h @ w.to(torch.float32)
        if b is not None:
            h = h + b.reshape(-1).to(torch.float32)
        h = apply_activation(h, act)
    return h.to(out_dtype)


def _rows_per_cta(M: int, wmax: int) -> int:
    """Rows per CTA: more rows share each weight read, fewer rows make
    more CTAs; the two activation buffers must fit shared memory."""
    most = 1 if M <= 1 else 4 if M <= 256 else 8
    for tm in (8, 4, 1):
        if tm <= most and (2 * tm * wmax + 8 * tm * 32) * 4 <= _SMEM_MAX:
            return tm
    raise ValueError(
        f"fc_stack_matmul: a layer width of {wmax} does not fit shared memory")


# The staged route (csrc/fc_stack.cu fcs_staged_kernel)
FCS_SMS = 132               # SMs of an H100: a grid aims at one wave
FCS_THREADS = 512           # threads per CTA (ST_NT)
FCS_PART = 16               # k rows per K part, about
FCS_TMS = (2, 4, 8, 16)     # rows per CTA, smallest first
FCS_ARGS = 512              # shared bytes of the stack and plan (ST_ARGS)


def k_split(K: int) -> Tuple[int, int]:
    """``(ks, per)``: the K parts of a K-deep layer and the k rows of each
    (a multiple of 4; the last part holds the rest, zero-padded to a
    multiple of 4).  It depends on K alone, so a result never depends on
    the rows per CTA or the grid."""
    ks = -(-K // FCS_PART)
    per = 4 * -(-K // (4 * ks))
    return -(-K // per), per


def _round4(v: int) -> int:
    return -(-v // 4) * 4


@dataclasses.dataclass(frozen=True)
class FcsPlan:
    """The staged kernel's split of one launch (``csrc/fc_stack.cu``
    ``fcs_staged_kernel``).

    CTA ``i`` owns rows ``tm * i`` onward (the last tile masked past M)
    and every column, and stages every layer's weights in shared memory,
    ``G_l = ceil(N_l / 4)`` groups of 4 columns wide.  Layer l's slots
    ``[0, ks[l] * items)``, ``items = tm / 2 * G_l``, are K part ``s //
    items`` and item ``s % items``: rows ``2 rp, 2 rp + 1`` (``rp = item //
    G_l``) by the 4 columns of group ``item % G_l``; part ``kp`` walks k
    rows ``[kp * per[l], (kp + 1) * per[l])`` in order.  The parts'
    sums are added in part order, then bias and activation."""
    tm: int         # rows per CTA (even)
    stride: int     # floats from one activation row to the next
    ks: tuple       # per layer: K parts (k_split)
    per: tuple      # per layer: k rows per part
    grid: int       # CTAs
    threads: int    # threads per CTA
    smem: int       # dynamic shared-memory bytes (the kernel has no static)

    def ints(self):
        """The plan as the kernel's int array (``StagedPlan``)."""
        return (self.tm, self.stride, *self.ks, *self.per)


def _staged_smem(dims, tm: int, stride: int, ks) -> int:
    """Shared-memory bytes of one staged CTA (``staged_smem``): the stack
    and plan, two (tm, stride) activation buffers, each layer's weights
    (round4(K) rows, round4(N) columns) and bias, and the largest layer's
    partial sums."""
    cols = [_round4(n) for n in dims[1:]]
    floats = (2 * tm * stride
              + sum(_round4(k) * c + c for k, c in zip(dims, cols))
              + max(p * tm * c for p, c in zip(ks, cols)))
    return FCS_ARGS + 4 * floats


def fcs_plan(M: int, dims: Sequence[int], tm: int) -> FcsPlan:
    """The staged plan of an M-row stack of widths ``dims`` (K_0, N_0,
    ..., N_last) at ``tm`` rows a CTA."""
    if tm < 2 or tm % 2:
        raise ValueError(f"fcs_plan: no staged plan at tm={tm}")
    dims = [int(d) for d in dims]
    kmax = max(_round4(k) for k in dims[:-1])
    stride = 32 * -(-(kmax - 4) // 32) + 4      # % 32 == 4, >= kmax
    splits = [k_split(k) for k in dims[:-1]]
    ks = tuple(k for k, _ in splits)
    per = tuple(p for _, p in splits)
    return FcsPlan(tm, stride, ks, per, -(-M // tm), FCS_THREADS,
                   _staged_smem(dims, tm, stride, ks))


def fcs_route(M: int, dims: Sequence[int], x_dtype):
    """``(route, plan)`` of an M-row stack of widths ``dims``, as a shape
    rule, computed once per (M, widths, x dtype): a forward calls it every
    time, and building plans costs microseconds of host time.

    ``("staged", FcsPlan)`` for f32 or bf16 x when a plan fits a CTA's
    shared memory: the fewest rows per CTA (of :data:`FCS_TMS`) that keep
    the grid within one wave of :data:`FCS_SMS` CTAs (the most rows when
    none does), or fewer where that plan does not fit (2 rows and 128 CTAs
    at LeNet's B = 256).  ``("stream", None)``, the first design,
    otherwise."""
    return _route(int(M), tuple(int(d) for d in dims), x_dtype)


@functools.lru_cache(maxsize=256)
def _route(M: int, dims: Tuple[int, ...], x_dtype):
    if x_dtype not in X_DTYPES or len(dims) - 1 > MAX_LAYERS:
        return "stream", None
    wave = next((t for t in FCS_TMS if -(-M // t) <= FCS_SMS), FCS_TMS[-1])
    for tm in reversed(FCS_TMS):
        if tm <= wave:
            plan = fcs_plan(M, dims, tm)
            if plan.smem <= _SMEM_MAX:
                return "staged", plan
    return "stream", None


def _lib():
    fn = build.library("fc_stack").fcs_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def _staged_lib():
    fn = build.library("fc_stack").fcs_staged_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, P, ctypes.c_longlong, P]
        fn.restype = ctypes.c_int
    return fn


def fc_stack_matmul(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[Optional[torch.Tensor]],
    activations: Sequence,
    *,
    name: str = "fc_stack_matmul",
) -> torch.Tensor:
    """y = actL(... act1(x @ W1 + b1) ... @ WL + bL), one launch, in x's
    dtype.

    ``x`` may be (..., K1); leading dims flatten to rows.  ``weights[i]``
    is dense f32 (K_i, N_i) with N_i == K_{i+1}; ``biases[i]`` is (N_i,)
    or None; ``activations[i]`` an epilogue activation or None.
    """
    global launches, launches_staged, launches_stream
    refuse_dtensor(name, x, *weights, *biases)
    dims = _check(x, weights, biases, activations)
    lead = x.shape[:-1]
    xm = x.reshape(-1, dims[0])
    if not x.is_cuda:
        y = fc_stack_matmul_ref(xm, weights, biases, activations,
                                out_dtype=x.dtype)
        return y.reshape(*lead, dims[-1])
    if x.dtype not in X_DTYPES:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    n = len(weights)
    if n > MAX_LAYERS:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers, got {n}")
    M = int(xm.shape[0])
    if M < 1:
        raise ValueError(f"{name}: needs at least one row, got M={M}")
    dev = x.device
    for i, w in enumerate(weights):
        if w.dtype != torch.float32:
            raise ValueError(
                f"{name}: layer {i} weight must be densified f32, got "
                f"{w.dtype}")
        check_cuda_operand(w, dev, f"layer {i} weight", name)
    route, plan = fcs_route(M, dims, x.dtype)
    out = _launch(xm.contiguous(), weights, biases, activations, route,
                  plan, name)
    launches += 1
    if route == "staged":
        launches_staged += 1
    else:
        launches_stream += 1
    return out.reshape(*lead, dims[-1])


def _launch(xm, weights, biases, activations, route: str,
            plan: Optional[FcsPlan] = None,
            name: str = "fc_stack_matmul") -> torch.Tensor:
    """Launch ``route``'s kernel ("staged" with its ``plan``, or "stream",
    the first design) on 2-D CUDA operands that passed
    :func:`fc_stack_matmul`'s checks; counts nothing (the wrapper counts).
    Either route may be asked for, to time one beside the other."""
    dims = [int(xm.shape[1])] + [int(w.shape[1]) for w in weights]
    n, M, dev = len(weights), int(xm.shape[0]), xm.device
    bs = [vec_f32(b, dims[i + 1], dev, f"layer {i} bias", name)
          for i, b in enumerate(biases)]
    codes = [act_args(a) for a in activations]
    out = torch.empty((M, dims[-1]), dtype=xm.dtype, device=dev)
    args = (ptr(xm), int(xm.dtype == torch.bfloat16), M, n,
            (ctypes.c_int * (n + 1))(*dims),
            (ctypes.c_void_p * n)(*[ptr(w) for w in weights]),
            (ctypes.c_void_p * n)(*[ptr(b) for b in bs]),
            (ctypes.c_int * n)(*[c for c, _ in codes]),
            (ctypes.c_float * n)(*[t for _, t in codes]),
            ptr(out))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "staged":
        ints = plan.ints()
        err = _staged_lib()(*args, (ctypes.c_int * len(ints))(*ints),
                            plan.smem, stream)
    elif route == "stream":
        err = _lib()(*args, _rows_per_cta(M, max(dims)), stream)
    else:
        raise ValueError(f"{name}: unknown fc-stack route {route!r}")
    build.check(err, name)
    return out
