"""Plain PyTorch versions of the block-sparse matmul and conv kernels."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import _check_activation, apply_activation, im2col_valid, pool_nhwc


def block_sparse_matmul_ref(
    x: torch.Tensor,
    blocks: torch.Tensor,
    block_rows,
    block_cols,
    *,
    n_row_blocks: int,
    n_col_blocks: int,
    scales: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Scatter the (dequantised) blocks back to dense and matmul in f32; the
    epilogue applies the kernel's bias + activation formulas.  The block
    coordinates may be host arrays or tensors on x's device."""
    _check_activation(activation)
    P, bk, bn = blocks.shape
    K, N = n_row_blocks * bk, n_col_blocks * bn
    dev = x.device
    rows = torch.as_tensor(block_rows, device=dev).long()
    cols = torch.as_tensor(block_cols, device=dev).long()
    w = blocks.to(torch.float32)
    if scales is not None:
        s = scales.reshape(n_col_blocks, bn).to(torch.float32)
        w = w * s[cols][:, None, :]
    dense = torch.zeros((n_row_blocks, n_col_blocks, bk, bn),
                        dtype=torch.float32, device=dev)
    if P:
        dense[rows, cols] = w
    dense = dense.permute(0, 2, 1, 3).reshape(K, N)
    y = x.to(torch.float32) @ dense
    if bias is not None:
        y = y + bias.reshape(N).to(torch.float32)[None, :]
    if activation is not None:
        y = apply_activation(y, activation)
    return y.to(out_dtype)


def split_bf16(w: torch.Tensor):
    """``(hi, lo)``: ``hi = bf16(w)`` and ``lo = bf16(w - hi)``, both
    rounded to nearest even, as the tensor-core route splits f32 blocks
    (``csrc/tc_matmul.cuh`` ``split``) to run them as two bf16 products of
    the same f32 sum.  ``w - hi`` is exact in f32; ``hi + lo`` holds ``w``
    to 2^-16 of its magnitude."""
    w = w.to(torch.float32)
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.to(torch.float32)).to(torch.bfloat16)


def block_sparse_conv_ref(
    x: torch.Tensor,
    blocks: torch.Tensor,
    block_rows,
    block_cols,
    *,
    kernel_hw,
    n_row_blocks: int,
    n_col_blocks: int,
    scales: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    strides=(1, 1),
    dilation=(1, 1),
    pool=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """im2col patches of the padded NHWC ``x`` through
    :func:`block_sparse_matmul_ref` (scale before the dot, bias and
    activation in f32), then the non-overlapping window pool."""
    B = x.shape[0]
    patches = im2col_valid(x.to(torch.float32), kernel_hw, strides, dilation)
    _, Ho, Wo, K = patches.shape
    y = block_sparse_matmul_ref(
        patches.reshape(B * Ho * Wo, K), blocks, block_rows, block_cols,
        n_row_blocks=n_row_blocks, n_col_blocks=n_col_blocks, scales=scales,
        bias=bias, activation=activation)
    y = y.reshape(B, Ho, Wo, -1)
    if pool is not None:
        y = pool_nhwc(y, pool)
    return y.to(out_dtype)
