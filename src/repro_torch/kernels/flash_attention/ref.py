"""Naive oracle of the flash attention kernel (full softmax attention).

A copy of ``repro.kernels.flash_attention.ref.flash_attention_ref``: the
causal mask aligns the LAST query with the last key (``tril(k=Tk-Tq)``),
which differs from the kernel's position-0 alignment when ``Tq != Tk``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    B, Tq, H, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kq = torch.repeat_interleave(k, G, dim=2)
    vq = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                     kq.to(torch.float32)) / math.sqrt(Dh)
    if causal:
        mask = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device), diagonal=Tk - Tq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, vq.to(torch.float32))
    return o.to(q.dtype)
