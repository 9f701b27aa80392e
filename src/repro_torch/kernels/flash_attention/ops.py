"""Public op: flash attention, the CUDA kernel forward with a recomputed
backward.

The forward runs :func:`~.kernel.flash_attention_fwd` (the kernel for CUDA
tensors, the plain version for CPU ones) and saves only q, k and v.  The
backward differentiates :func:`repro_torch.models.layers.chunked_attention`
recomputed from them, as ``repro.kernels.flash_attention.ops`` does with
``jax.vjp``: the reference has no backward kernel, so neither has the port.
A query offset (a sequence-sharded rank's rows) goes to both: the forward
kernel and the recompute mask at the same absolute positions.
"""
from __future__ import annotations

import torch

from ...models.layers import chunked_attention
from .kernel import flash_attention_fwd

__all__ = ["flash_attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = chunked_attention(q, k, v, causal=ctx.causal,
                                  q_offset=ctx.q_offset)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Tq, H, Dh) over k, v (B, Tk, Hkv, Dh), q's row i
    at position ``q_offset + i`` (0: causal positions aligned at 0);
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, int(q_offset))
