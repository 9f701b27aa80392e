"""Public op: sparse linear layer over a CompressedLinear weight."""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch

from ...core.sparsity import BlockSparsePattern, CompressedLinear
from .kernel import Schedule, block_sparse_matmul, make_schedule
from .ref import block_sparse_matmul_ref

# pattern -> {device: Schedule}: each pattern's schedule is uploaded once per
# device, like the TPU kernel's scalar-prefetched schedule tables
_SCHEDULES: "weakref.WeakKeyDictionary[BlockSparsePattern, Dict[str, Schedule]]" \
    = weakref.WeakKeyDictionary()


def schedule_for(pattern: BlockSparsePattern, device) -> Schedule:
    """The pattern's device-resident schedule, built on first use."""
    per_dev = _SCHEDULES.setdefault(pattern, {})
    key = str(torch.device(device))
    sched = per_dev.get(key)
    if sched is None:
        nR, nC = pattern.bitmap.shape
        sched = make_schedule(pattern.block_rows, pattern.block_cols, nR, nC,
                              device)
        per_dev[key] = sched
    return sched


def sparse_linear(
    x: torch.Tensor,
    cl: CompressedLinear,
    *,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    out_dtype=None,
    use_kernel: bool = True,
    leaf: Optional[str] = None,
    plan=None,
) -> torch.Tensor:
    """y = act(x @ W + b) for a compile-time-compacted W.

    ``x`` may be (..., K); leading dims flatten to M (thin decode batches
    included: the kernel masks rows past M).  A bit-packed ``cl`` packed
    along bk (bk divisible by the code count) reaches the kernel in its
    container; any other packing unpacks to the int8 codes first.
    ``use_kernel=False`` runs the plain version.  ``out_dtype`` defaults to
    x's dtype; x is cast to it first.  ``plan``: a tuned ``(route, plan)``
    for the kernel (``block_sparse_matmul``'s ``plan`` with
    ``tuned=True``: one the call cannot take runs the shape rule's).
    """
    pat = cl.pattern
    K, N = pat.shape
    name = leaf or "sparse_linear"
    if x.shape[-1] != K:
        raise ValueError(
            f"{name}: activation feature dim {x.shape[-1]} does not match the "
            f"compiled weight's K={K} (= {pat.bitmap.shape[0]} row blocks x "
            f"{pat.block[0]}); a bare reshape would silently fold batch rows "
            "into features — fix the caller's shape")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead = x.shape[:-1]
    xm = x.reshape(-1, K).to(out_dtype)
    blocks, packed = cl.blocks, False
    if cl.packed:
        if use_kernel and cl.blocks.axis % 3 == 1 \
                and pat.block[0] % cl.blocks.per_byte == 0:
            blocks, packed = cl.blocks.data, cl.blocks.container
        else:
            blocks = cl.block_values()
    if use_kernel:
        y = block_sparse_matmul(xm.contiguous(), blocks,
                                schedule_for(pat, x.device), scales=cl.scales,
                                bias=bias, activation=activation,
                                packed=packed, name=name, plan=plan,
                                tuned=plan is not None)
    else:
        nR, nC = pat.bitmap.shape
        y = block_sparse_matmul_ref(
            xm, blocks, pat.block_rows, pat.block_cols, n_row_blocks=nR,
            n_col_blocks=nC, scales=cl.scales, bias=bias,
            activation=activation, out_dtype=out_dtype)
    return y.reshape(*lead, N)
