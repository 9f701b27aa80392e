"""Fused FC stack — the wrapper of the CUDA kernel.

``y = actL(... act1(x @ W1 + b1) ... @ WL + bL)`` in one launch: adjacent
linears (LeNet's fc1 -> fc2 -> fc3) share a row tile whose intermediate
activations never leave the chip.  The weights arrive dense f32 (the
dispatch densifies whatever container a layer compiled to).  The kernel
(``csrc/fc_stack.cu``) replaces the Pallas kernel of
``repro.kernels.fc_stack``; its plain PyTorch version is
:func:`fc_stack_matmul_ref`.

The wrapper launches the kernel for CUDA tensors and takes the plain
version for CPU tensors, and only then.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build
from .sparse_matmul.kernel import (
    X_DTYPES,
    _check_activation,
    act_args,
    apply_activation,
    check_cuda_operand,
    ptr,
    vec_f32,
)

__all__ = ["fc_stack_matmul", "fc_stack_matmul_ref", "launches"]

# kernel launches since the counter was last set to 0
launches = 0

MAX_LAYERS = 8                   # csrc/fc_stack.cu MAXL
_SMEM_MAX = 232448               # the H100's per-block shared memory


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


def _lib():
    fn = build.library("fc_stack").fcs_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, I, P]
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
    global launches
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
    xm = xm.contiguous()
    for i, w in enumerate(weights):
        if w.dtype != torch.float32:
            raise ValueError(
                f"{name}: layer {i} weight must be densified f32, got "
                f"{w.dtype}")
        check_cuda_operand(w, dev, f"layer {i} weight", name)
    bs = [vec_f32(b, dims[i + 1], dev, f"layer {i} bias", name)
          for i, b in enumerate(biases)]
    codes = [act_args(a) for a in activations]
    out = torch.empty((M, dims[-1]), dtype=x.dtype, device=dev)
    err = _lib()(
        ptr(xm), int(x.dtype == torch.bfloat16), M, n,
        (ctypes.c_int * (n + 1))(*dims),
        (ctypes.c_void_p * n)(*[ptr(w) for w in weights]),
        (ctypes.c_void_p * n)(*[ptr(b) for b in bs]),
        (ctypes.c_int * n)(*[c for c, _ in codes]),
        (ctypes.c_float * n)(*[t for _, t in codes]),
        ptr(out), _rows_per_cta(M, max(dims)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    launches += 1
    return out.reshape(*lead, dims[-1])
