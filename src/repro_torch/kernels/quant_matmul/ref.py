"""Plain PyTorch version of the quantised matmul kernel (epilogue included)."""
from __future__ import annotations

import torch

from ..sparse_matmul.kernel import apply_activation


def quant_matmul_ref(x, w_q, scales, bias=None, activation=None,
                     out_dtype=torch.float32):
    """y = act(x @ dequant(W) + b), all in f32, with the kernel's epilogue
    formulas."""
    w = w_q.to(torch.float32) * scales.to(torch.float32)[None, :]
    y = x.to(torch.float32) @ w
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    if activation is not None:
        y = apply_activation(y, activation)
    return y.to(out_dtype)
