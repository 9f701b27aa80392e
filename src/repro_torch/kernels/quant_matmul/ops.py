"""Public op: quantised linear over a QuantizedTensor or PackedTensor."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ...core.quant import PackedTensor, QuantizedTensor
from .kernel import quant_matmul
from .ref import quant_matmul_ref


def quant_linear(
    x: torch.Tensor,
    qt: Union[QuantizedTensor, PackedTensor],
    *,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    out_dtype=None,
    use_kernel: bool = True,
    leaf: Optional[str] = None,
    plan=None,
) -> torch.Tensor:
    """y = act(x @ dequant(W) + b); x may be (..., K).

    A :class:`PackedTensor` packed along K (K divisible by its code count)
    reaches the kernel in its container; any other packing unpacks to the
    int8 codes first.  ``use_kernel=False`` runs the plain version.
    ``out_dtype`` defaults to x's dtype; x is cast to it first.  ``plan``:
    a tuned ``(route, plan)`` for the kernel (``quant_matmul``'s ``plan``
    with ``tuned=True``: one the call cannot take runs the shape rule's).
    """
    packed = False
    if isinstance(qt, PackedTensor):
        K, N = qt.shape
        if use_kernel and qt.axis % 2 == 0 and K % qt.per_byte == 0:
            values, packed = qt.data, qt.container
        else:
            values = qt.unpack()
        scales = qt.scales.reshape(N)
    else:
        K, N = qt.values.shape
        values, scales = qt.values, qt.scales.reshape(N)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead = x.shape[:-1]
    xm = x.reshape(-1, K).to(out_dtype)
    if use_kernel:
        y = quant_matmul(xm.contiguous(), values, scales, bias,
                         activation=activation, packed=packed,
                         name=leaf or "quant_linear", plan=plan,
                         tuned=plan is not None)
    else:
        y = quant_matmul_ref(xm, values, scales, bias=bias,
                             activation=activation, out_dtype=out_dtype)
    return y.reshape(*lead, N)
