"""Plain PyTorch versions of the quantised matmul and conv kernels (epilogue
included)."""
from __future__ import annotations

import torch

from ..sparse_matmul.kernel import apply_activation, im2col_valid, pool_nhwc


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


def quant_conv_ref(x, w_q, scales, bias=None, *, kernel_hw, activation=None,
                   strides=(1, 1), dilation=(1, 1), pool=None,
                   out_dtype=torch.float32):
    """im2col patches of the padded NHWC ``x`` times the (K, N) codes in
    f32, then the kernel's emit order: ``acc * s + b``, the activation, and
    the non-overlapping window pool."""
    patches = im2col_valid(x.to(torch.float32), kernel_hw, strides, dilation)
    y = patches @ w_q.to(torch.float32)
    y = y * scales.reshape(-1).to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(-1).to(torch.float32)
    if activation is not None:
        y = apply_activation(y, activation)
    if pool is not None:
        y = pool_nhwc(y, pool)
    return y.to(out_dtype)
