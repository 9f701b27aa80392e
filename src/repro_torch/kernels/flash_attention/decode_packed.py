"""Attention read over the bit-packed int4x2 KV cache — kernel wrapper and
plain version.

The serving cache stores K/V as int4 codes packed two per uint8 byte along
Dh, with one f32 scale per (slot, position, kv head).  The read attends
straight from codes x scales with an online softmax over ``bt``-row tiles,
skipping tiles at or past each query row's live length, so the result does
not depend on the cache extent at a fixed ``bt``.

* :func:`packed_decode_attention` — the wrapper of ``csrc/
  packed_decode_attention.cu`` (replacing the Pallas kernel of
  ``repro.kernels.flash_attention.decode_packed``), for decode (C = 1) and
  prefill chunks (C > 1).  CPU tensors take the plain version.
* :func:`tiled_packed_attention` — the plain PyTorch version, the same tile
  walk, masking and final ``acc / max(l, 1e-30)`` division.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from ...core.quant import unpack_int4

__all__ = ["packed_decode_attention", "tiled_packed_attention", "launches"]

NEG_INF = -1e30

# kernel launches since the counter was last set to 0
launches = 0


def _lib():
    fn = build.library("packed_decode_attention").pda_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, L, L, P]
        fn.restype = ctypes.c_int
    return fn


def _slot_stride(t: torch.Tensor, inner, what: str, name: str) -> int:
    """Slot (axis 0) stride of a cache leaf whose other axes are dense."""
    if tuple(t.stride()[1:]) != tuple(inner):
        raise ValueError(
            f"{name}: {what} must be dense past its slot axis (strides "
            f"{tuple(t.stride())}, expected (*, {', '.join(map(str, inner))}))")
    return int(t.stride(0))


def packed_decode_attention(
    q: torch.Tensor,        # (B, C, H, Dh)
    k_p: torch.Tensor,      # (B, T, Hkv, Dh/2) uint8
    v_p: torch.Tensor,
    k_s: torch.Tensor,      # (B, T, Hkv) f32
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C) live length per query row
    *,
    bt: int = 64,
    name: str = "packed_decode_attention",
) -> torch.Tensor:
    """Attention of C query rows per slot over the packed cache, in q's
    dtype.  Cache leaves may be views whose slot stride exceeds T rows
    (a bounded extent of a longer cache)."""
    global launches
    if not q.is_cuda:
        return tiled_packed_attention(q, k_p, v_p, k_s, v_s, lengths, bt=bt)
    B, C, H, Dh = q.shape
    T, Hkv, Dhp = (int(d) for d in k_p.shape[1:])
    if Dh % 2 or Dhp != Dh // 2:
        raise ValueError(
            f"{name}: the kernel needs an even head dim packed two codes per "
            f"byte, got Dh={Dh} with {Dhp} bytes per row")
    if H % Hkv:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    if bt < 1:
        raise ValueError(f"{name}: bt must be positive, got {bt}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    for t, what in ((k_p, "k_p"), (v_p, "v_p")):
        if t.dtype != torch.uint8 or t.device != q.device:
            raise ValueError(f"{name}: {what} must be uint8 on {q.device}")
    for t, what in ((k_s, "k_s"), (v_s, "v_s")):
        if t.dtype != torch.float32 or t.device != q.device \
                or tuple(t.shape[1:]) != (T, Hkv):
            raise ValueError(
                f"{name}: {what} must be f32 (B, {T}, {Hkv}) on {q.device}")
    kv_stride = _slot_stride(k_p, (Hkv * Dhp, Dhp, 1), "k_p", name)
    if _slot_stride(v_p, (Hkv * Dhp, Dhp, 1), "v_p", name) != kv_stride:
        raise ValueError(f"{name}: k_p and v_p slot strides differ")
    s_stride = _slot_stride(k_s, (Hkv, 1), "k_s", name)
    if _slot_stride(v_s, (Hkv, 1), "v_s", name) != s_stride:
        raise ValueError(f"{name}: k_s and v_s slot strides differ")
    if tuple(lengths.shape) != (B, C):
        raise ValueError(f"{name}: lengths must be (B, C) = {(B, C)}")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).contiguous()
    out = torch.empty((B, C, H, Dh), dtype=q.dtype, device=q.device)
    err = _lib()(qf.data_ptr(), k_p.data_ptr(), v_p.data_ptr(),
                 k_s.data_ptr(), v_s.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), int(q.dtype == torch.bfloat16), B, C, H,
                 Hkv, Dh, T, int(bt), kv_stride, s_stride,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    launches += 1
    return out


def tiled_packed_attention(
    q: torch.Tensor,        # (B, C, H, Dh)
    k_c: torch.Tensor,      # packed uint8 (B, T, Hkv, ceil(Dh/2))
    v_c: torch.Tensor,
    k_s: torch.Tensor,      # (B, T, Hkv) f32
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C)
    *,
    bt: int = 64,
) -> torch.Tensor:
    """Plain version: tile-by-tile online softmax; a tile that is dead for
    a (b, c) row leaves that row's (m, l, acc) untouched."""
    B, C, H, Dh = q.shape
    T, Hkv = k_c.shape[1], k_c.shape[2]
    G = H // Hkv
    n_t = max(1, -(-T // bt))
    dev = q.device
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(B, C, Hkv, G, Dh)
    lengths = lengths.to(device=dev, dtype=torch.int32)

    m = torch.full((B, C, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, C, Hkv, G, Dh), dtype=torch.float32, device=dev)
    for it in range(n_t):
        lo, hi = it * bt, min((it + 1) * bt, T)
        codes_k = unpack_int4(k_c[:, lo:hi], Dh, axis=-1)
        codes_v = unpack_int4(v_c[:, lo:hi], Dh, axis=-1)
        kf = codes_k.to(torch.float32) * k_s[:, lo:hi, :, None]
        vf = codes_v.to(torch.float32) * v_s[:, lo:hi, :, None]
        s = torch.einsum("bcHgd,btHd->bcHgt", qf, kf)
        kpos = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        valid = kpos[None, None, :] < lengths[:, :, None]          # (B, C, t)
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] \
            + torch.einsum("bcHgt,btHd->bcHgd", p, vf)
        live = (lo < lengths)[:, :, None, None]                    # (B, C)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, C, H, Dh).to(q.dtype)
