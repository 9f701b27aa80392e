"""Engine-free static block-sparse matmul — the wrapper of the CUDA kernel.

``y[M, N] = act(x[M, K] @ W + b)`` where W is stored block-compacted: only
present (bk, bn) blocks exist, enumerated by a static schedule.  The kernel
(``csrc/block_sparse_matmul.cu``) replaces the Pallas kernel of
``repro.kernels.sparse_matmul.kernel``; its plain PyTorch version is
:func:`repro_torch.kernels.sparse_matmul.ref.block_sparse_matmul_ref`.

A wrapper launches the kernel for CUDA tensors and takes the plain version
for CPU tensors, and only then.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import build

__all__ = ["ACTIVATIONS", "Schedule", "apply_activation",
           "block_sparse_matmul", "make_schedule", "launches"]

# kernel launches since the counter was last set to 0
launches = 0

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
    """

    col_ptr: torch.Tensor   # (n_col_blocks + 1,) int32
    rows: torch.Tensor      # (P,) int32
    pidx: torch.Tensor      # (P,) int32
    block_rows: np.ndarray
    block_cols: np.ndarray
    n_row_blocks: int
    n_col_blocks: int


def make_schedule(block_rows, block_cols, n_row_blocks: int,
                  n_col_blocks: int, device) -> Schedule:
    """Sort the present blocks by (col, row) and upload the CSC schedule."""
    block_rows = np.asarray(block_rows)
    block_cols = np.asarray(block_cols)
    order = np.lexsort((block_rows, block_cols))
    cols = block_cols[order].astype(np.int64)
    col_ptr = np.zeros(n_col_blocks + 1, np.int32)
    col_ptr[1:] = np.cumsum(np.bincount(cols, minlength=n_col_blocks))
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                       device=device)
    return Schedule(col_ptr=as_dev(col_ptr), rows=as_dev(block_rows[order]),
                    pidx=as_dev(order), block_rows=block_rows,
                    block_cols=block_cols, n_row_blocks=int(n_row_blocks),
                    n_col_blocks=int(n_col_blocks))


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
) -> torch.Tensor:
    """y = act(x @ W + b) for a block-compacted W, in x's dtype.

    ``blocks`` is ``(P, bk, bn)`` (f32, bf16 or int8 codes with ``scales``)
    or, with ``packed`` "int4x2"/"int2x4", the uint8 container
    ``(P, bk / ratio, bn)`` packed along bk.  Columns whose block column is
    absent — every column of an empty pattern — come back as ``act(b)``.
    Any M >= 1 runs as is: the kernel's row tile masks the rows past M, so
    thin decode batches (the TPU kernel's separate decode entry) need no
    padding.  ``name`` labels errors (the dispatch passes the leaf name).
    """
    global launches
    ratio = packed_ratio(packed)
    P, bkp, bn = (int(d) for d in blocks.shape)
    bk = bkp * ratio
    M, K = x.shape
    if K != schedule.n_row_blocks * bk:
        raise ValueError(
            f"{name}: K={K} != n_row_blocks*bk={schedule.n_row_blocks * bk}")
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
    code, tau = act_args(activation)
    kind = w_kind(blocks, ratio, name)
    dev = x.device
    check_cuda_operand(x, dev, "x", name)
    check_cuda_operand(blocks, dev, "blocks", name)
    check_cuda_operand(schedule.col_ptr, dev, "the schedule", name)
    if P != int(schedule.rows.numel()):
        raise ValueError(
            f"{name}: {P} blocks but the schedule lists "
            f"{int(schedule.rows.numel())}")
    N = schedule.n_col_blocks * bn
    s = vec_f32(scales, N, dev, "scales", name)
    b = vec_f32(bias, N, dev, "bias", name)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = _lib()(ptr(x), int(x.dtype == torch.bfloat16), M, K, ptr(blocks),
                 kind, bk, bn, ptr(s), ptr(b), ptr(schedule.col_ptr),
                 ptr(schedule.rows), ptr(schedule.pidx),
                 schedule.n_col_blocks, ptr(out), rows_per_cta(M), code, tau,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    launches += 1
    return out
