"""Shared building blocks: norms, RoPE, the full-sequence and float-cache
attention reads and the compressed-linear and conv aliases.

Every cast sits where the reference (``repro.models.layers``) puts it, so
the same inputs round at the same places.  The reference scales q as
``(q * scale).astype(f32)`` with ``scale = 1 / np.sqrt(Dh)`` a numpy
float64, which JAX promotes to f32 before the multiply; the port writes
that as ``q.to(f32) * scale``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import payload_registry, sharded
from ..core.dispatch import conv_dispatch, linear_dispatch
from ..core.sparsity import BlockSparsePattern

Params = Dict[str, Any]


def linear_init(generator: torch.Generator, K: int, N: int, *,
                dtype=torch.bfloat16, bias: bool = False, mode: str = "dense",
                pattern=None, lead: Tuple[int, ...] = ()) -> Params:
    """Random leaves of one linear in any registered family's form, drawn
    from ``generator`` on its device, with the leading axes ``lead`` (a
    layer stack).

    ``mode`` names an init mode of a family ("dense" | "int8" | "sparse" |
    "sparse_int8" | "gsparse" | "gsparse_int8" | "perchannel_int8" |
    "bfp8"); ``pattern`` is its static side-information (a
    BlockSparsePattern for the block-sparse modes, the group count for the
    group-diagonal ones).  ``bias`` adds a zero ``b`` leaf."""
    p = dict(payload_registry.init_leaves(mode, generator, K, N, dtype=dtype,
                                          pattern=pattern, lead=lead))
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (N,), dtype=dtype,
                             device=generator.device)
    return p


def linear_apply(p: Params, x: torch.Tensor, *,
                 pattern: Optional[BlockSparsePattern] = None,
                 compute_dtype=None, activation=None, dispatch=None,
                 leaf: Optional[str] = None) -> torch.Tensor:
    """Apply one linear leaf, y = act(x @ W + b) — an alias of
    :func:`repro_torch.core.dispatch.linear_dispatch`."""
    return linear_dispatch(p, x, pattern=pattern, dispatch=dispatch,
                           compute_dtype=compute_dtype, activation=activation,
                           leaf=leaf)


def conv_apply(cp, x: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
               activation=None, compute_dtype=None, dispatch=None,
               leaf: Optional[str] = None) -> torch.Tensor:
    """Apply one compiled conv leaf, y = act(conv(x, W) + b) in NHWC — an
    alias of :func:`repro_torch.core.dispatch.conv_dispatch` for any
    conv-bearing config (CNN stems, ViT patch embeddings)."""
    return conv_dispatch(cp, x, dispatch=dispatch, bias=bias,
                         activation=activation, compute_dtype=compute_dtype,
                         leaf=leaf)


# --------------------------------------------------------------------- norms


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """A norm parameter in the compute dtype (a placed one through
    :func:`repro_torch.core.sharded.upcast`)."""
    return sharded.upcast(t, dtype) if sharded.is_dtensor(t) else t.to(dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * _as(p["g"], x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * _as(p["g"], x.dtype) + _as(p["b"], x.dtype)


# ---------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T).  Placed (DTensor) x and
    positions rotate each rank's local shard."""
    if sharded.is_dtensor(x):
        return sharded.rope(x, positions, theta, apply_rope)
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ----------------------------------------------------------------- attention


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient (online-softmax) attention over KV chunks: q (B, Tq,
    H, Dh), k / v (B, Tk, Hkv, Dh) -> (B, Tq, H, Dh) in q's dtype.

    Peak temp is (B, H, Tq, kv_chunk) instead of (B, H, Tq, Tk).  A ragged
    Tk pads to whole chunks and masks ``k_pos < Tk``; masked scores are
    ``-inf``.  GQA: head h reads kv head h // G through the (Hkv, G) layout.
    ``q_offset`` is the absolute position of q[0].  Differentiable: the
    flash op's backward recomputes this function under autograd.
    """
    B, Tq, H, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"chunked_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    G = H // Hkv
    nchunks = max(1, -(-Tk // kv_chunk))
    pad = nchunks * kv_chunk - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(
        B, Tq, Hkv, G, Dh)
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    m = torch.full((B, Hkv, G, Tq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Tq, Dh), dtype=torch.float32,
                      device=q.device)
    for c in range(nchunks):
        lo = c * kv_chunk
        kb = k[:, lo:lo + kv_chunk].to(torch.float32)
        vb = v[:, lo:lo + kv_chunk].to(torch.float32)
        s = torch.einsum("bqHgd,bcHd->bHgqc", qf, kb)
        k_pos = lo + torch.arange(kv_chunk, device=q.device)
        mask = (k_pos < Tk)[None, :].expand(Tq, kv_chunk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bHgqc,bcHd->bHgqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    # (B, Hkv, G, Tq, Dh) -> (B, Tq, H, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """One query row per slot over a float cache: q (B, 1, H, Dh),
    caches (B, T, Hkv, Dh), length (B,)."""
    B, _, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(B, Hkv, G, Dh)
    s = torch.einsum("bHgd,btHd->bHgt", qf, k_cache.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, :] < length[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bHgt,btHd->bHgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def attention_lse(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths: torch.Tensor):
    """C query rows per slot over a float cache with per-row extents
    ``lengths`` (B, C), which may be 0: returns the f32 output (B, C, H, Dh)
    and each row's log-sum-exp of its scaled scores (B, C, H), for a
    partial read that is combined with others (a sequence-sharded cache,
    :func:`repro_torch.core.sharded.seq_combine`).  A row with no live key
    gives 0 and -inf, never NaN."""
    B, C, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(
        B, C, Hkv, G, Dh)
    s = torch.einsum("bcHgd,btHd->bcHgt", qf, k_cache.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, None, :] \
        < lengths[:, :, None]
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bcHgt,btHd->bcHgd", p, v_cache.to(torch.float32))
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("-inf")))
    return o.reshape(B, C, H, Dh), lse.reshape(B, C, H)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """:func:`decode_attention` batched over a chunk of C query rows with a
    per-row extent ``lengths`` (B, C)."""
    B, C, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(
        B, C, Hkv, G, Dh)
    s = torch.einsum("bcHgd,btHd->bcHgt", qf, k_cache.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, None, :] < lengths[:, :, None]
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bcHgt,btHd->bcHgd", p, v_cache.to(torch.float32))
    return o.reshape(B, C, H, Dh).to(q.dtype)
