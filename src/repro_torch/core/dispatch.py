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
  int2       {"w_q2", "w_s"}     quant_matmul (int2x4)    quant_matmul_ref
  perchannel {"w_pc", "w_pcs"}   quant_matmul, x*s first  quant_matmul_ref
  bfp8       {"w_bfp", "w_bfpe"} quant_matmul, s = 2^e    quant_matmul_ref
  sparse     {"w_blk"[, "w_s"]}  block_sparse_matmul      block_sparse_matmul_ref
  sparse_packed {"w_blkp", "w_s"} block_sparse_matmul     block_sparse_matmul_ref
             (int4x2 / int2x4)
  actsparse  {"w_ablk", "w_atau"} block_sparse_matmul,    block_sparse_matmul_ref
                                 relu -> ("trelu", tau)
  gsparse    {"w_grp"[, "w_s"]}  —  (s batched products, as the reference
                                 computes it outside any kernel)

Full-sequence attention (:func:`attn_full_dispatch`, the training and
prefill forward) takes the ``flash_attention`` op — the CUDA kernel forward
with a recomputed ``chunked_attention`` backward — and its plain version is
``chunked_attention`` itself.

Modes (:class:`DispatchConfig`, from an explicit ``dispatch=`` argument, else
the ``REPRO_TORCH_DISPATCH`` environment variable, else ``auto``):

* ``auto``   — the kernel for CUDA tensors, the plain version for CPU ones;
* ``kernel`` — the kernel; a CPU tensor raises;
* ``twin``   — the plain version, on any device.

Nothing here sends a CUDA tensor to the plain version on its own: a shape or
dtype the kernel cannot take raises, naming the leaf.  The fused bias +
activation epilogue rides the kernels' emit step; every other path applies
the same f32 formulas (:func:`_epilogue`).

Convolutions (:func:`conv_dispatch`) run a compiled :class:`ConvPayload`
through its family's fused conv kernel (``block_sparse_conv`` /
``quant_conv``: patches gathered in the kernel, optional pooled emit);
where the reference has no fused entry (the dense family, a pool window
that does not tile the output) and under ``twin``, the conv lowers to
im2col patches and the linear path above.  :func:`fc_stack_dispatch` runs a
chain of linear payloads through one ``fc_stack_matmul`` launch.
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.fc_stack import fc_stack_matmul
from ..kernels.flash_attention.decode_packed import (
    packed_decode_attention,
    tiled_packed_attention,
)
from ..kernels.quant_matmul.kernel import quant_conv
from ..kernels.quant_matmul.ops import quant_linear
from ..kernels.sparse_matmul.kernel import (
    POOL_MODES,
    _check_activation,
    apply_activation,
    block_sparse_conv,
    im2col_valid,
    pool_nhwc as _pool_nhwc,
    valid_out_hw,
)
from ..kernels.sparse_matmul.ops import sparse_linear
from . import payload_registry
from .sparsity import BlockSparsePattern

__all__ = [
    "ATTN_BT_DEFAULT",
    "DISPATCH_ENV",
    "DISPATCH_MODES",
    "POOL_MODES",
    "ConvPayload",
    "DispatchConfig",
    "attn_full_dispatch",
    "attn_packed_dispatch",
    "attn_packed_eligible",
    "conv_dispatch",
    "conv_im2col",
    "conv_out_hw",
    "conv_pre_pad",
    "derived",
    "fc_stack_dispatch",
    "gsparse_apply",
    "linear_dispatch",
    "payload_dispatch",
    "perchannel_fold",
    "resolve",
    "unit_scales",
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


def attn_packed_eligible(Dh: int, bt: int, packed: bool = True) -> bool:
    """Can the packed attention kernel read this cache?  Nibble pairs stay
    inside one byte only for an even head dim (the int8 codes of the
    unpacked container take any); any positive tile works."""
    return (Dh % 2 == 0 or not packed) and bt > 0


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
    unwrap it to its family's leaf dict and run :func:`linear_dispatch`.
    A :class:`ConvPayload` raises: it goes through :func:`conv_dispatch`."""
    if isinstance(payload, ConvPayload):
        raise TypeError(
            "ConvPayload must go through conv_dispatch (it carries the "
            "kernel geometry the conv lowering needs), not payload_dispatch")
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
    k_c: torch.Tensor,      # packed uint8 (B, T, Hkv, ceil(Dh/2)) or int8
    v_c: torch.Tensor,      #   codes (B, T, Hkv, Dh) when packed=False
    k_s: torch.Tensor,      # (B, T, Hkv) f32 per-row scales
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B, C) live length per query row
    *,
    packed: bool,
    dispatch: Union[None, str, DispatchConfig] = None,
    bt: Optional[int] = None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """The quantised KV-cache attention read: codes -> attention output,
    without a dequantised copy of the cache.  ``packed`` names the
    container: int4x2 (two codes a byte) or int4 (int8 codes).  Decode
    rows and prefill chunks of both containers take the kernel
    (``packed_decode_attention``); ``twin`` takes
    :func:`tiled_packed_attention`.  ``bt`` defaults to
    :data:`ATTN_BT_DEFAULT`."""
    cfg = resolve(dispatch)
    bt = ATTN_BT_DEFAULT if bt is None else int(bt)
    name = leaf or "attn.kv"
    if not use_kernel(cfg, q, name):
        return tiled_packed_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt,
                                      packed=packed)
    if not attn_packed_eligible(q.shape[-1], bt, packed):
        raise ValueError(
            f"{name}: the packed attention kernel needs a positive tile and, "
            f"for int4x2 codes, an even head dim; got Dh={q.shape[-1]}, "
            f"bt={bt}")
    return packed_decode_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt,
                                   packed=packed, name=name)


def attn_full_dispatch(
    q: torch.Tensor,        # (B, T, H, Dh)
    k: torch.Tensor,        # (B, T, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool,
    dispatch: Union[None, str, DispatchConfig] = None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """Full-sequence attention, causal positions aligned at 0.  A CUDA tensor
    takes the ``flash_attention`` op under ``auto`` and ``kernel`` (a shape
    the kernel cannot take raises); ``twin``, and ``auto`` on the CPU, take
    :func:`repro_torch.models.layers.chunked_attention`, which is also what
    the op's backward recomputes."""
    # imported here: models.layers imports this module
    from ..kernels.flash_attention.ops import flash_attention
    from ..models.layers import chunked_attention

    cfg = resolve(dispatch)
    if use_kernel(cfg, q, leaf or "attn.full") and q.is_cuda:
        return flash_attention(q, k, v, causal)
    return chunked_attention(q, k, v, causal=causal)


# ------------------------------------------------ family-specific pieces


def perchannel_fold(x: torch.Tensor, s: torch.Tensor,
                    compute_dtype) -> torch.Tensor:
    """Fold a per-input-channel scale into the activation, ``x * s`` in the
    compute dtype (one rounding, in that dtype, as the reference does it):
    the product then sees plain codes with unit output scales."""
    return x.to(compute_dtype) * s.to(compute_dtype)


# (N, device) -> ones(N) f32: the unit output scales of a product whose
# scale was folded into the activation, made once (never inside a capture)
_UNIT_SCALES: Dict[Tuple[int, str], torch.Tensor] = {}


def unit_scales(N: int, device) -> torch.Tensor:
    key = (int(N), str(torch.device(device)))
    t = _UNIT_SCALES.get(key)
    if t is None:
        t = _UNIT_SCALES[key] = torch.ones((int(N),), dtype=torch.float32,
                                           device=device)
    return t


def gsparse_apply(w: torch.Tensor, scales: Optional[torch.Tensor],
                  x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Group-diagonal static sparsity as s dense products: output column
    group c reads input row group ``(s - c) % s``.  ``w`` is the (s, Kg, Ng)
    group stack, ``scales`` the optional (N,) dequant vector; feature
    f = (q, g) of x and column j = (r, c) of y, as the reference lays them
    out.  Plain torch, as the reference computes it outside any kernel."""
    s, Kg, Ng = (int(d) for d in w.shape)
    N = s * Ng
    lead = x.shape[:-1]
    xm = x.reshape(-1, Kg, s).to(compute_dtype)
    wf = w.to(compute_dtype)
    if scales is not None:
        wf = wf * scales.reshape(s, 1, Ng).to(compute_dtype)
    order = [(s - c) % s for c in range(s)]
    xg = xm[:, :, order].permute(2, 0, 1)             # (s, M, Kg)
    yg = torch.bmm(xg, wf)                            # (s, M, Ng)
    return yg.permute(1, 2, 0).reshape(*lead, N)      # j = (r, c)


# --------------------------------------------------- values derived once

# payload id -> (weak reference to the payload, {(what, device): tensor})
_DERIVED: Dict[int, Tuple[weakref.ref, Dict[Tuple[str, str], torch.Tensor]]] \
    = {}


def derived(payload: Any, what: str, device,
            make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()`` on ``device``, computed once per payload object, ``what``
    and device, and dropped with the payload — the eager counterpart of the
    reference's trace-time densify / unpack (a per-call dequantise would
    cost a pass over the weight on every forward)."""
    key = id(payload)
    entry = _DERIVED.get(key)
    if entry is None or entry[0]() is not payload:
        entry = (weakref.ref(payload, lambda _, k=key: _DERIVED.pop(k, None)),
                 {})
        _DERIVED[key] = entry
    sub = (what, str(torch.device(device)))
    t = entry[1].get(sub)
    if t is None:
        t = make().to(device).contiguous()
        if t is payload:  # nothing derived: holding it would keep it alive
            return t
        entry[1][sub] = t
    return t


# ------------------------------------------------------------ convolutions


@dataclasses.dataclass(eq=False)
class ConvPayload:
    """A compiled convolution leaf: one linear-family payload over the
    im2col weight matrix — ``(kh, kw, cin, cout)`` reshaped to ``(K =
    cin*kh*kw, N = cout)`` in the channel-major patch order — plus the
    static geometry it was compiled for.  :func:`conv_dispatch` rejects a
    call with another geometry."""

    payload: Any
    kernel: Tuple[int, int, int, int]   # (kh, kw, cin, cout)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "VALID"
    dilation: Tuple[int, int] = (1, 1)

    @property
    def K(self) -> int:
        kh, kw, cin, _ = self.kernel
        return kh * kw * cin

    @property
    def N(self) -> int:
        return self.kernel[3]


def conv_out_hw(in_hw: Tuple[int, int], kernel_hw: Tuple[int, int],
                strides: Tuple[int, int], padding: str,
                dilation: Tuple[int, int] = (1, 1)) -> Tuple[int, int]:
    """Static (H_out, W_out) of a conv: SAME is ``ceil(H / stride)`` (as
    XLA); VALID uses the dilated kernel extent ``(k - 1) * d + 1``."""
    H, W = in_hw
    if padding == "SAME":
        return -(-H // strides[0]), -(-W // strides[1])
    return valid_out_hw(H, W, kernel_hw, strides, dilation)


def _same_pads(H: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """XLA's SAME split for one axis: total ``max((ceil(H/s) - 1)*s +
    (k-1)*d + 1 - H, 0)``, the low side gets the floor half."""
    Ho = -(-H // s)
    p = max((Ho - 1) * s + (k - 1) * d + 1 - H, 0)
    return p // 2, p - p // 2


def conv_pre_pad(x: torch.Tensor, kernel_hw: Tuple[int, int], *,
                 strides: Tuple[int, int], padding: str,
                 dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Resolve SAME padding to an explicit zero-pad of the NHWC input, so
    every lowering (the fused kernels and im2col) sees VALID geometry."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(
            f"conv supports 'VALID' or 'SAME' padding, got {padding!r}")
    kh, kw = kernel_hw
    sh, sw = strides
    dh, dw = dilation
    _, H, W, _ = x.shape
    ph_lo, ph_hi = _same_pads(H, kh, sh, dh)
    pw_lo, pw_hi = _same_pads(W, kw, sw, dw)
    if not (ph_lo or ph_hi or pw_lo or pw_hi):
        return x
    return F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))


def conv_im2col(x: torch.Tensor, kernel_hw: Tuple[int, int], *,
                strides: Tuple[int, int] = (1, 1), padding: str = "VALID",
                dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """NHWC image -> (B, H_out, W_out, cin*kh*kw) patches in the
    channel-major order f = c*kh*kw + dh*kw + dw (bitwise the reference's
    ``conv_im2col``); SAME pads first (:func:`conv_pre_pad`)."""
    if x.ndim != 4:
        raise ValueError(
            f"conv_im2col expects NHWC input, got shape {tuple(x.shape)}")
    x = conv_pre_pad(x, kernel_hw, strides=strides, padding=padding,
                     dilation=dilation)
    return im2col_valid(x, kernel_hw, strides, dilation)


def _conv_fused(cp: ConvPayload, x: torch.Tensor, cfg: DispatchConfig,
                bias, activation, compute_dtype, leaf: Optional[str],
                pool: Optional[Tuple[str, int]]) -> Optional[torch.Tensor]:
    """The family's fused conv entry over the pre-padded input, or None
    where the reference has none: a family without a ``conv_fused`` hook
    (dense), a pool window that does not tile the output, an empty output,
    or ``twin``."""
    fam = payload_registry.family_of_payload(cp.payload)
    if fam is None or fam.conv_fused is None:
        return None
    kh, kw = cp.kernel[:2]
    _, H, W, _ = x.shape
    Ho, Wo = conv_out_hw((H, W), (kh, kw), cp.strides, cp.padding,
                         cp.dilation)
    if Ho < 1 or Wo < 1:
        return None
    if pool is not None and (Ho % pool[1] or Wo % pool[1]):
        return None
    xp = conv_pre_pad(x, (kh, kw), strides=cp.strides, padding=cp.padding,
                      dilation=cp.dilation)
    out_dtype = compute_dtype if compute_dtype is not None else x.dtype
    return fam.conv_fused(cp, xp, cfg=cfg, bias=bias, activation=activation,
                          out_dtype=out_dtype, leaf=leaf, pool=pool)


def conv_dispatch(
    cp: ConvPayload,
    x: torch.Tensor,
    *,
    strides: Optional[Tuple[int, int]] = None,
    padding: Optional[str] = None,
    dilation: Optional[Tuple[int, int]] = None,
    dispatch: Union[None, str, DispatchConfig] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    compute_dtype=None,
    leaf: Optional[str] = None,
    pool: Optional[Tuple[str, int]] = None,
) -> torch.Tensor:
    """Apply one compiled conv leaf: y = pool(act(conv(x, W) + b)).

    The kernel leg is the family's fused conv (``block_sparse_conv`` /
    ``quant_conv``): patches gathered in the kernel, ``pool=(mode, size)``
    fused into the emit, one launch.  Where the fused entry does not apply
    (see :func:`_conv_fused`) the conv lowers to im2col patches through
    :func:`payload_dispatch`, and ``pool`` follows as a separate step.

    ``strides``/``padding``/``dilation`` default to the compiled geometry;
    a different value raises — the payload was compiled for one conv.
    """
    if not isinstance(cp, ConvPayload):
        raise TypeError(
            f"conv_dispatch needs a ConvPayload (from compile_sparse), got "
            f"{type(cp).__name__}")
    kh, kw, cin, cout = cp.kernel
    if strides is not None and tuple(strides) != tuple(cp.strides):
        raise ValueError(
            f"conv_dispatch strides {tuple(strides)} do not match the "
            f"compiled payload's strides {tuple(cp.strides)} — the leaf was "
            "compiled for that geometry; recompile instead of overriding")
    if padding is not None and padding != cp.padding:
        raise ValueError(
            f"conv_dispatch padding {padding!r} does not match the compiled "
            f"payload's padding {cp.padding!r} — recompile instead of "
            "overriding")
    if dilation is not None and tuple(dilation) != tuple(cp.dilation):
        raise ValueError(
            f"conv_dispatch dilation {tuple(dilation)} does not match the "
            f"compiled payload's dilation {tuple(cp.dilation)} — the leaf "
            "was compiled for that geometry; recompile instead of "
            "overriding")
    if x.ndim != 4 or x.shape[-1] != cin:
        raise ValueError(
            f"conv_dispatch: input shape {tuple(x.shape)} does not match the "
            f"compiled kernel (kh={kh}, kw={kw}, cin={cin}, cout={cout}) — "
            f"expected NHWC with trailing channel dim {cin}")
    if pool is not None and (pool[0] not in POOL_MODES or int(pool[1]) < 1):
        raise ValueError(
            f"unknown conv pool {pool!r} — expected (mode, size) with mode "
            f"in {POOL_MODES} and size >= 1")
    _check_activation(activation)
    cfg = resolve(dispatch)
    y = _conv_fused(cp, x, cfg, bias, activation, compute_dtype, leaf, pool)
    if y is not None:
        return y
    patches = conv_im2col(x, (kh, kw), strides=cp.strides,
                          padding=cp.padding, dilation=cp.dilation)
    y = payload_dispatch(cp.payload, patches, dispatch=cfg, bias=bias,
                         activation=activation, compute_dtype=compute_dtype,
                         leaf=leaf)
    if pool is not None:
        y = _pool_nhwc(y, pool)
    return y


# ------------------------------------------------------------ layer fusion


def _payload_dense_f32(payload: Any, device) -> torch.Tensor:
    """A linear payload densified to (K, N) f32 on ``device`` by its
    family's ``payload_dense`` hook, once per payload and device."""
    fam = payload_registry.family_of_payload(payload)
    if fam is None or fam.payload_dense is None:
        raise TypeError(
            f"no registered payload family densifies {type(payload).__name__}")
    return derived(payload, "dense_f32", device,
                   lambda: fam.payload_dense(payload))


def _payload_kn(payload: Any) -> Tuple[int, int]:
    fam = payload_registry.family_of_payload(payload)
    if fam is None or fam.payload_kn is None:
        raise TypeError(
            f"no registered payload family matches {type(payload).__name__}")
    return fam.payload_kn(payload)


def _stack_activation(payload: Any, activation):
    """The epilogue ``payload_dispatch`` would run for this payload: an
    actsparse payload (a host ``tau``) sharpens a ReLU into its
    threshold-ReLU, as its family's ``apply`` does."""
    tau = getattr(payload, "tau", None)
    if activation == "relu" and isinstance(tau, (int, float)):
        return ("trelu", float(tau))
    return activation


def fc_stack_dispatch(
    payloads: Sequence[Any],
    x: torch.Tensor,
    *,
    biases: Sequence[Optional[torch.Tensor]],
    activations: Sequence,
    dispatch: Union[None, str, DispatchConfig] = None,
    compute_dtype=None,
    leaves: Optional[Sequence[str]] = None,
) -> torch.Tensor:
    """Apply a chain of compiled linear payloads as one fused stack.

    The kernel leg runs :func:`repro_torch.kernels.fc_stack.fc_stack_matmul`
    over the densified f32 weights (:func:`_payload_dense_f32`): one launch,
    intermediates never leave the chip.  ``twin`` chains the per-leaf
    :func:`payload_dispatch` plain versions — the same result to float
    tolerance (a sparse container's twin sums K block by block), each
    payload's own epilogue included (:func:`_stack_activation`).
    """
    n = len(payloads)
    if not (n == len(biases) == len(activations)):
        raise ValueError(
            f"fc_stack_dispatch needs matching payloads/biases/activations, "
            f"got lengths {n}/{len(biases)}/{len(activations)}")
    cfg = resolve(dispatch)
    if compute_dtype is None:
        compute_dtype = x.dtype
    leaves = list(leaves) if leaves is not None else [None] * n
    dims = [_payload_kn(p) for p in payloads]
    for (lp, (_, n_prev)), (lf, (k_next, _)) in zip(
            zip(leaves, dims), zip(leaves[1:], dims[1:])):
        if n_prev != k_next:
            raise ValueError(
                f"fc_stack_dispatch: {lp} outputs {n_prev} features but {lf} "
                f"takes {k_next}")
    stack_leaf = "+".join(str(lf) for lf in leaves)
    if use_kernel(cfg, x, stack_leaf):
        ws = [_payload_dense_f32(p, x.device) for p in payloads]
        acts = [_stack_activation(p, a)
                for p, a in zip(payloads, activations)]
        return fc_stack_matmul(x.to(compute_dtype), ws, list(biases), acts,
                               name=stack_leaf)
    y = x
    for payload, b, act, lf in zip(payloads, biases, activations, leaves):
        y = payload_dispatch(payload, y, dispatch=cfg, bias=b,
                             activation=act, compute_dtype=compute_dtype,
                             leaf=lf)
    return y


# Register the built-in payload families: the family modules take their
# helpers from THIS module at call time, so the import sits below every
# definition.
from . import families as _families  # noqa: E402,F401
