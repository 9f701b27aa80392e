"""Shared building blocks: norms, RoPE, the float-cache attention reads and
the compressed-linear alias.

Every cast sits where the reference (``repro.models.layers``) puts it, so
the same inputs round at the same places.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..core.dispatch import linear_dispatch
from ..core.sparsity import BlockSparsePattern

Params = Dict[str, Any]


def linear_apply(p: Params, x: torch.Tensor, *,
                 pattern: Optional[BlockSparsePattern] = None,
                 compute_dtype=None, activation=None, dispatch=None,
                 leaf: Optional[str] = None) -> torch.Tensor:
    """Apply one linear leaf, y = act(x @ W + b) — an alias of
    :func:`repro_torch.core.dispatch.linear_dispatch`."""
    return linear_dispatch(p, x, pattern=pattern, dispatch=dispatch,
                           compute_dtype=compute_dtype, activation=activation,
                           leaf=leaf)


# --------------------------------------------------------------------- norms


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * p["g"].to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["g"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ----------------------------------------------------------------- attention


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """One query row per slot over a float cache: q (B, 1, H, Dh),
    caches (B, T, Hkv, Dh), length (B,)."""
    B, _, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = (q * (1.0 / math.sqrt(Dh))).to(torch.float32).reshape(B, Hkv, G, Dh)
    s = torch.einsum("bHgd,btHd->bHgt", qf, k_cache.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, :] < length[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bHgt,btHd->bHgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """:func:`decode_attention` batched over a chunk of C query rows with a
    per-row extent ``lengths`` (B, C)."""
    B, C, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = (q * (1.0 / math.sqrt(Dh))).to(torch.float32).reshape(B, C, Hkv, G, Dh)
    s = torch.einsum("bcHgd,btHd->bcHgt", qf, k_cache.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, None, :] < lengths[:, :, None]
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bcHgt,btHd->bcHgd", p, v_cache.to(torch.float32))
    return o.reshape(B, C, H, Dh).to(q.dtype)
