"""Full-sequence flash attention forward — kernel wrapper and plain version.

* :func:`flash_attention_fwd` — the wrapper of the two CUDA kernels that
  replace the Pallas kernel ``repro.kernels.flash_attention.kernel.
  flash_attention``: causal or not, GQA, bf16 or f32, any ``Tq`` / ``Tk``,
  ``Dh`` up to 256; q, k and v are read through their strides.
  :func:`flash_route` picks the kernel from the shapes: ``"tensor_core"``
  (``csrc/flash_attention_tc.cu``, wgmma) for bf16 with Dh 64, 80, 96 or
  128 and 16-byte-aligned rows, ``"cuda_core"``
  (``csrc/flash_attention.cu``, f32 FMAs) for everything else.  CPU tensors take the plain version.
* :func:`flash_attention_plain` — the plain PyTorch version of what the
  kernel computes: ``q.float() * scale``, an online softmax over
  :data:`BK`-key tiles with the finite mask value :data:`NEG_INF`, causal
  positions aligned at 0 (``kpos <= qpos``), output ``acc / max(l, 1e-30)``
  in q's dtype.

Both take ``q_offset``, the absolute position of q's first row (0 for a
whole sequence, a sequence-sharded rank's first row otherwise): causal
masking then keeps ``kpos <= q_offset + qpos``; non-causal calls ignore it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build, refuse_dtensor

__all__ = ["BK", "NEG_INF", "flash_attention_fwd", "flash_attention_plain",
           "flash_route", "launches", "launches_cc", "launches_tc"]

NEG_INF = -1e30
BK = 64          # keys per tile of the kernel's online softmax
MAX_DH = 256
TC_DH = (64, 80, 96, 128)   # head dims of the tensor-core kernel
TC_BQ = 128         # q rows per CTA of the tensor-core kernel
CC_BQ = 64          # q rows per CTA of the CUDA-core kernel

# kernel launches since the counters were last set to 0: all of them, and
# those of each route
launches = 0
launches_tc = 0
launches_cc = 0


def _lib(route: str):
    if route == "tensor_core":
        fn = build.library("flash_attention_tc").flash_attention_tc_launch
        head = []
    else:
        fn = build.library("flash_attention").flash_attention_launch
        head = [ctypes.c_int]        # bf16 flag
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, *head, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L, ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes these inputs: ``"tensor_core"`` when q, k and v are
    all bf16 with Dh in :data:`TC_DH`, unit stride along Dh, every other
    stride of a dimension longer than 1 a multiple of 8 elements and base
    pointers 16-byte aligned (each row is then whole 16-byte copies);
    ``"cuda_core"`` otherwise.  A shape rule, not a fallback: the CUDA-core
    kernel is the one that takes f32, other head dims and odd strides."""
    ts = (q, k, v)
    if any(t.dtype != torch.bfloat16 for t in ts) or q.shape[-1] not in TC_DH:
        return "cuda_core"
    for t in ts:
        if t.dim() != 4 or t.stride(3) != 1 or t.data_ptr() % 16:
            return "cuda_core"
        if any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            return "cuda_core"
    return "tensor_core"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"{name}: expected q (B, Tq, H, Dh) and k, v (B, Tk, Hkv, Dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{name}: H={H} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if k.shape[1] < 1:
        raise ValueError(f"{name}: needs at least one key, got Tk=0")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        name: str = "flash_attention") -> torch.Tensor:
    """Attention of q (B, Tq, H, Dh) over k, v (B, Tk, Hkv, Dh) -> (B, Tq,
    H, Dh) in q's dtype; q's row i sits at position ``q_offset + i``."""
    global launches, launches_tc, launches_cc
    refuse_dtensor(name, q, k, v)
    _check(q, k, v, name)
    q_offset = _offset(q_offset, name)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    route = flash_route(q, k, v)
    out = _launch(q, k, v, causal, route, name, q_offset)
    launches += 1
    if route == "tensor_core":
        launches_tc += 1
    else:
        launches_cc += 1
    return out


def _offset(q_offset, name: str) -> int:
    q_offset = int(q_offset)
    if not 0 <= q_offset <= 2 ** 30:      # the kernels' positions are int32
        raise ValueError(f"{name}: q_offset must be in [0, 2^30], got "
                         f"{q_offset}")
    return q_offset


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            route: str, name: str = "flash_attention",
            q_offset: int = 0) -> torch.Tensor:
    """Launch the ``route`` kernel on CUDA tensors that passed ``_check``;
    counts nothing (the wrapper counts)."""
    B, Tq, H, Dh = (int(d) for d in q.shape)
    Tk, Hkv = int(k.shape[1]), int(k.shape[2])
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must all be f32 or all bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= Dh <= MAX_DH:
        raise ValueError(f"{name}: the kernel takes 1 <= Dh <= {MAX_DH}, "
                         f"got {Dh}")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on "
                             f"{q.device}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what} needs unit stride along Dh, got "
                             f"strides {tuple(t.stride())}")
    tc = route == "tensor_core"
    if tc and flash_route(q, k, v) != route:
        raise ValueError(f"{name}: the tensor-core kernel does not take "
                         f"these inputs (see flash_route)")
    if -(-Tq // (TC_BQ if tc else CC_BQ)) > 65535:
        raise ValueError(f"{name}: Tq={Tq} exceeds the kernel's grid")
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    if Tq == 0 or B == 0:
        return out
    head = () if tc else (int(q.dtype == torch.bfloat16),)
    err = _lib(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *head, B, Tq, Tk, H, Hkv, Dh,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      1.0 / math.sqrt(Dh), int(bool(causal)), int(q_offset),
                      torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version: the kernel's online softmax over :data:`BK`-key tiles,
    every tile in one pass over all q rows (a tile wholly in a row's future
    leaves the row's (m, l, acc) unchanged, as the kernel's skip does)."""
    _check(q, k, v, "flash_attention_plain")
    q_offset = _offset(q_offset, "flash_attention_plain")
    B, Tq, H, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(Dh))).reshape(
        B, Tq, Hkv, G, Dh)
    qpos = q_offset + torch.arange(Tq, device=dev)
    m = torch.full((B, Hkv, G, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Tq, Dh), dtype=torch.float32, device=dev)
    # keys at or past q_offset + Tq lie in the future of every row
    for lo in range(0, min(Tk, q_offset + Tq) if causal else Tk, BK):
        hi = min(lo + BK, Tk)
        kf = k[:, lo:hi].to(torch.float32)
        vf = v[:, lo:hi].to(torch.float32)
        s = torch.einsum("bqHgd,bcHd->bHgqc", qf, kf)
        if causal:
            kpos = torch.arange(lo, hi, device=dev)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bHgqc,bcHd->bHgqd", p, vf)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dh).to(q.dtype)
