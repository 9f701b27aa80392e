"""Unified compressed-linear dispatch — one entry for every leaf family.

Every linear of the port executes through :func:`linear_dispatch`, which
resolves the compiled leaves to their registered
:class:`repro_torch.core.payload_registry.PayloadFamily`; the family's
``apply`` runs the CUDA kernel or its plain PyTorch version:

  leaf family                    kernel                   plain version
  ---------------------------    ---------------------    --------------------
  dense      {"w"}               —  (torch.matmul)        torch.matmul
  quant      {"w_q", "w_s"}      quant_matmul             quant_matmul_ref
  quant_packed {"w_qp", "w_s"}   quant_matmul (int4x2)    quant_matmul_ref
  sparse     {"w_blk"[, "w_s"]}  block_sparse_matmul      block_sparse_matmul_ref
  sparse_packed {"w_blkp", "w_s"} block_sparse_matmul     block_sparse_matmul_ref
             (int4x2 / int2x4)

Modes (:class:`DispatchConfig`, from an explicit ``dispatch=`` argument, else
the ``REPRO_TORCH_DISPATCH`` environment variable, else ``auto``):

* ``auto``   — the kernel for CUDA tensors, the plain version for CPU ones;
* ``kernel`` — the kernel; a CPU tensor raises;
* ``twin``   — the plain version, on any device.

Nothing here sends a CUDA tensor to the plain version on its own: a shape or
dtype the kernel cannot take raises, naming the leaf.  The fused bias +
activation epilogue rides the kernels' emit step; every other path applies
the same f32 formulas (:func:`_epilogue`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Union

import torch

from ..kernels.flash_attention.decode_packed import (
    packed_decode_attention,
    tiled_packed_attention,
)
from ..kernels.quant_matmul.ops import quant_linear
from ..kernels.sparse_matmul.kernel import _check_activation, apply_activation
from ..kernels.sparse_matmul.ops import sparse_linear
from . import payload_registry
from .sparsity import BlockSparsePattern

__all__ = [
    "ATTN_BT_DEFAULT",
    "DISPATCH_ENV",
    "DISPATCH_MODES",
    "DispatchConfig",
    "attn_packed_dispatch",
    "attn_packed_eligible",
    "linear_dispatch",
    "payload_dispatch",
    "resolve",
    "use_kernel",
]

Params = Dict[str, Any]

DISPATCH_ENV = "REPRO_TORCH_DISPATCH"
DISPATCH_MODES = ("auto", "kernel", "twin")

# kv-tile rows of the packed attention read.  The serving engine pins it for
# the cache's lifetime: the online softmax is extent-invariant only at a
# fixed tile size.
ATTN_BT_DEFAULT = 64


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Kernel-or-plain-version selection (see the module docstring)."""

    mode: str = "auto"

    def __post_init__(self):
        if self.mode not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {self.mode!r} — valid: "
                f"{DISPATCH_MODES} (from {DISPATCH_ENV} or dispatch=)")


def resolve(dispatch: Union[None, str, DispatchConfig] = None) -> DispatchConfig:
    """Normalise a dispatch override to a DispatchConfig (None reads
    ``REPRO_TORCH_DISPATCH``, default ``auto``; unknown modes raise)."""
    if isinstance(dispatch, DispatchConfig):
        return dispatch
    if dispatch is None:
        dispatch = os.environ.get(DISPATCH_ENV, "auto").strip() or "auto"
    return DispatchConfig(mode=str(dispatch).lower())


def use_kernel(cfg: DispatchConfig, x: torch.Tensor,
               leaf: Optional[str] = None) -> bool:
    """True: call the kernel's wrapper (which launches the kernel for a
    CUDA tensor and takes the plain version for a CPU one, in ``auto``);
    False: call the plain version directly (``twin``).  ``kernel`` mode
    raises for a CPU tensor instead of computing it with the plain
    version."""
    if cfg.mode == "twin":
        return False
    if cfg.mode == "kernel" and not x.is_cuda:
        raise ValueError(
            f"dispatch mode 'kernel' for leaf {leaf or '<unnamed>'!r}: the "
            f"input is on {x.device}, and the CUDA kernels run only on "
            "CUDA tensors — use 'auto' or 'twin' on the CPU")
    return True


def attn_packed_eligible(Dh: int, bt: int) -> bool:
    """Can the packed attention kernel read this cache?  Nibble pairs stay
    inside one byte only for an even head dim; any positive tile works."""
    return Dh % 2 == 0 and bt > 0


def _epilogue(y: torch.Tensor, bias, activation, out_dtype) -> torch.Tensor:
    """f32 bias + activation, shared by every non-fused path."""
    if bias is None and activation is None:
        return y.to(out_dtype)
    y = y.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = apply_activation(y, activation)
    return y.to(out_dtype)


def linear_dispatch(
    p: Params,
    x: torch.Tensor,
    *,
    pattern: Optional[BlockSparsePattern] = None,
    dispatch: Union[None, str, DispatchConfig] = None,
    compute_dtype=None,
    activation=None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """Apply one compiled linear leaf: y = act(x @ W + b).

    The leaf dict's key leaf selects its registered family, whose ``apply``
    runs the kernel or the plain version.  ``p["b"]`` and ``activation``
    fuse into the kernels' epilogue.  ``leaf`` names the layer in errors.
    """
    _check_activation(activation)
    cfg = resolve(dispatch)
    if compute_dtype is None:
        compute_dtype = x.dtype
    fam = payload_registry.validate_leaves(p, pattern)
    if fam is None or fam.apply is None:
        raise ValueError(f"unknown linear leaves {list(p)}")
    return fam.apply(p, x, pattern=pattern, cfg=cfg, bias=p.get("b"),
                     activation=activation, compute_dtype=compute_dtype,
                     leaf=leaf)


def payload_dispatch(
    payload: Any,
    x: torch.Tensor,
    *,
    dispatch: Union[None, str, DispatchConfig] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    compute_dtype=None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """Dispatch over a payload object (CompressedLinear — optionally
    bit-packed — PackedTensor, QuantizedTensor or a plain dense tensor):
    unwrap it to its family's leaf dict and run :func:`linear_dispatch`."""
    fam, leaves, pattern = payload_registry.unwrap_payload(payload)
    if fam is None:
        raise TypeError(
            f"no registered payload family matches "
            f"{type(payload).__name__} — registered: "
            f"{[f.name for f in payload_registry.all_families()]}")
    p: Params = dict(leaves)
    if bias is not None:
        p["b"] = bias
    return linear_dispatch(p, x, pattern=pattern, dispatch=dispatch,
                           compute_dtype=compute_dtype,
                           activation=activation, leaf=leaf)


def attn_packed_dispatch(
    q: torch.Tensor,        # (B, C, H, Dh) — decode C=1, prefill chunk C>1
    k_c: torch.Tensor,      # packed uint8 (B, T, Hkv, ceil(Dh/2))
    v_c: torch.Tensor,
    k_s: torch.Tensor,      # (B, T, Hkv) f32 per-row scales
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C) live length per query row
    *,
    dispatch: Union[None, str, DispatchConfig] = None,
    bt: Optional[int] = None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """The int4x2 KV-cache attention read: codes -> attention output,
    without a dequantised copy of the cache.  Decode rows and prefill
    chunks both take the kernel (``packed_decode_attention``); ``twin``
    takes :func:`tiled_packed_attention`.  ``bt`` defaults to
    :data:`ATTN_BT_DEFAULT`."""
    cfg = resolve(dispatch)
    bt = ATTN_BT_DEFAULT if bt is None else int(bt)
    name = leaf or "attn.kv"
    if not use_kernel(cfg, q, name):
        return tiled_packed_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt)
    if not attn_packed_eligible(q.shape[-1], bt):
        raise ValueError(
            f"{name}: the packed attention kernel needs an even head dim and "
            f"a positive tile, got Dh={q.shape[-1]}, bt={bt}")
    return packed_decode_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt,
                                   name=name)


# Register the built-in payload families: the family modules take their
# helpers from THIS module at call time, so the import sits below every
# definition.
from . import families as _families  # noqa: E402,F401
