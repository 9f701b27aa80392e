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
* ``twin``   — the plain version, on any device;
* ``autotune`` — ``auto`` with the on-disk tuned table
  (:func:`repro_torch.core.autotune.load_table`) attached.

A tuned table (``DispatchConfig.tuned``) names, per (kind, shape, dtype,
backend, schedule) key, the kernel route and plan each matmul launches
(:func:`tuned_plan`); a plan the call cannot take runs the shape rule's
route instead, counted in the wrapper's ``tuned_misses``.

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

import contextlib
import dataclasses
import math
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
from . import payload_registry, sharded
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
    "fused_conv_entry",
    "gsparse_apply",
    "linear_dispatch",
    "payload_dispatch",
    "perchannel_fold",
    "resolve",
    "tuned_plan",
    "unit_scales",
    "use_kernel",
]

Params = Dict[str, Any]

DISPATCH_ENV = "REPRO_TORCH_DISPATCH"
DISPATCH_MODES = ("auto", "kernel", "twin")
# accepted by resolve() beside DISPATCH_MODES: auto with the tuned table
AUTOTUNE_MODE = "autotune"

# kv-tile rows of the packed attention read.  The serving engine pins it for
# the cache's lifetime: the online softmax is extent-invariant only at a
# fixed tile size.
ATTN_BT_DEFAULT = 64


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Kernel-or-plain-version selection (see the module docstring).

    ``tuned``: an optional :class:`repro_torch.core.autotune.TunedTable`
    (identity-hashed, so this stays hashable) whose entries name each
    matmul's route and plan.  ``m_bucket`` pins the rows of tuned lookups
    (bucketed by ``autotune.bucket_m``); None: each call looks up its own
    rows.  The serving engine pins its ``batch_slots``."""

    mode: str = "auto"
    tuned: Optional[Any] = None
    m_bucket: Optional[int] = None

    def __post_init__(self):
        if self.mode not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {self.mode!r} — valid: "
                f"{DISPATCH_MODES} or {AUTOTUNE_MODE!r} (from {DISPATCH_ENV} "
                "or dispatch=)")
        if self.m_bucket is not None and int(self.m_bucket) < 1:
            raise ValueError(
                f"illegal m_bucket={self.m_bucket!r} — tuned lookups need a "
                "positive row count (or None for each call's own rows)")


def resolve(dispatch: Union[None, str, DispatchConfig] = None) -> DispatchConfig:
    """Normalise a dispatch override to a DispatchConfig (None reads
    ``REPRO_TORCH_DISPATCH``, default ``auto``; ``autotune`` is ``auto``
    with the on-disk tuned table, empty when there is none; unknown modes
    raise)."""
    if isinstance(dispatch, DispatchConfig):
        return dispatch
    if dispatch is None:
        dispatch = os.environ.get(DISPATCH_ENV, "auto").strip() or "auto"
    mode = str(dispatch).lower()
    if mode == AUTOTUNE_MODE:
        from .autotune import load_table
        return DispatchConfig(mode="auto", tuned=load_table())
    return DispatchConfig(mode=mode)


# While a step's operations are counted (repro_torch.launch.op_costs), the
# attention reads run inside named ranges, so that the count can tell their
# traffic apart; off otherwise, so a profile of the card sees no extra
# range.
NAMED_RANGES = False


def named_range(name: str):
    """``torch.profiler.record_function(name)`` while :data:`NAMED_RANGES`
    is on, else a no-op context."""
    if NAMED_RANGES:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


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


def _lead_rows(x: torch.Tensor) -> int:
    return int(math.prod(x.shape[:-1]))


def _tuned_entry(cfg: DispatchConfig, kind: str, M: int, K: int, N: int,
                 x_dtype, device, pattern: Optional[BlockSparsePattern] = None,
                 leaf: Optional[str] = None, container: Optional[str] = None):
    """The tuned table's entry for a call (None: no table or no entry):
    the per-leaf key first when ``leaf`` is named, then the shared one.
    ``M`` is the call's rows, or the config's pinned ``m_bucket``; the
    backend is ``device``'s."""
    if cfg.tuned is None:
        return None
    from .autotune import backend_tag, tune_key
    if cfg.m_bucket is not None:
        M = int(cfg.m_bucket)
    kw = dict(kind=kind, M=M, K=K, N=N, dtype=x_dtype,
              backend=backend_tag(device), pattern=pattern,
              container=container)
    if leaf is not None:
        entry = cfg.tuned.get(tune_key(**kw, leaf=leaf))
        if entry is not None:
            return entry
    return cfg.tuned.get(tune_key(**kw))


def _kernel_entry(entry, x: torch.Tensor, leaf: Optional[str], kind: str):
    """``entry`` for a kernel call, or None where the plain version runs
    (a CPU entry on a CPU tensor).  An entry naming the plain version on a
    CUDA tensor raises: the plain version is never chosen for one."""
    if entry is None or entry.use_kernel:
        return entry
    if x.is_cuda:
        raise ValueError(
            f"{leaf or '<unnamed>'}: the tuned {kind} entry names the plain "
            f"version (use_kernel=False) for a tensor on {x.device}; a CUDA "
            "tensor always takes a kernel — retune on this card")
    return None


def tuned_plan(cfg: DispatchConfig, kind: str, x: torch.Tensor, K: int,
               N: int, *, pattern: Optional[BlockSparsePattern] = None,
               leaf: Optional[str] = None,
               container: Optional[str] = None):
    """The ``(route, plan)`` the tuned table names for a matmul on ``x``
    (rows ``x``'s leading dims), or None: no table, no entry, ``twin``, or
    a CPU entry (the plain version, which the wrapper takes for a CPU
    tensor anyway).  ``kind`` is "quant" / "sparse", ``conv_``-prefixed on
    the im2col path; ``container`` the leaf's container tag."""
    if cfg.tuned is None or cfg.mode == "twin":
        return None
    entry = _kernel_entry(
        _tuned_entry(cfg, kind, _lead_rows(x), K, N, x.dtype, x.device,
                     pattern, leaf, container), x, leaf, kind)
    return None if entry is None else (entry.route, entry.plan)


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
    op: str = "linear",
) -> torch.Tensor:
    """Apply one compiled linear leaf: y = act(x @ W + b).

    The leaf dict's key leaf selects its registered family, whose ``apply``
    runs the kernel or the plain version.  ``p["b"]`` and ``activation``
    fuse into the kernels' epilogue.  ``leaf`` names the layer in errors
    and in per-leaf tuned lookups; ``op`` ("linear" | "conv") tags the
    tuned key, so an im2col'd conv never shares a linear's entries.

    Placed (DTensor) leaves and input run the same call on each rank's
    local shards, column-parallel, row-parallel or replicated by the key
    leaf's placement (:func:`repro_torch.core.sharded.linear`).
    """
    _check_activation(activation)
    if op not in ("linear", "conv"):
        raise ValueError(f"unknown dispatch op {op!r} — 'linear' or 'conv'")
    cfg = resolve(dispatch)
    if compute_dtype is None:
        compute_dtype = x.dtype
    tag = "conv_" if op == "conv" else ""
    if sharded.any_dtensor(x, *p.values()):
        fam = payload_registry.family_for_leaves(p)
        if fam is None or fam.apply is None:
            raise ValueError(f"unknown linear leaves {list(p)}")
        return sharded.linear(fam, p, x, pattern=pattern, cfg=cfg,
                              activation=activation,
                              compute_dtype=compute_dtype, leaf=leaf,
                              tag=tag, validate=payload_registry.validate_leaves)
    fam = payload_registry.validate_leaves(p, pattern)
    if fam is None or fam.apply is None:
        raise ValueError(f"unknown linear leaves {list(p)}")
    return fam.apply(p, x, pattern=pattern, cfg=cfg, bias=p.get("b"),
                     activation=activation, compute_dtype=compute_dtype,
                     leaf=leaf, tag=tag)


def payload_dispatch(
    payload: Any,
    x: torch.Tensor,
    *,
    dispatch: Union[None, str, DispatchConfig] = None,
    bias: Optional[torch.Tensor] = None,
    activation=None,
    compute_dtype=None,
    leaf: Optional[str] = None,
    op: str = "linear",
) -> torch.Tensor:
    """Dispatch over a payload object (CompressedLinear — optionally
    bit-packed — PackedTensor, QuantizedTensor or a plain dense tensor):
    unwrap it to its family's leaf dict and run :func:`linear_dispatch`
    (``op`` as there).
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
                           activation=activation, leaf=leaf, op=op)


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
    return_lse: bool = False,
):
    """The quantised KV-cache attention read: codes -> attention output,
    without a dequantised copy of the cache.  ``packed`` names the
    container: int4x2 (two codes a byte) or int4 (int8 codes).  Decode
    rows and prefill chunks of both containers take the kernel
    (``packed_decode_attention``); ``twin`` takes
    :func:`tiled_packed_attention`.  ``bt`` comes from the caller, else
    the tuned ``attn_packed`` entry, else :data:`ATTN_BT_DEFAULT` (the
    serving engine pins it for the cache's lifetime).  On a placed cache
    (DTensors) the read runs on each rank's slots and kv heads, or on each
    rank's range of a sequence-sharded cache, the ranks' parts combined
    (:func:`repro_torch.core.sharded.attn_packed`).  ``return_lse`` returns
    ``(out, lse)``, each row's log-sum-exp beside it (that combine's
    input)."""
    with named_range("attention.packed"):
        return _attn_packed(q, k_c, v_c, k_s, v_s, lengths, packed=packed,
                            cfg=resolve(dispatch), bt=bt, leaf=leaf,
                            return_lse=return_lse)


def _attn_packed(q, k_c, v_c, k_s, v_s, lengths, *, packed, cfg, bt, leaf,
                 return_lse):
    if sharded.any_dtensor(q, k_c, v_c, k_s, v_s, lengths):
        return sharded.attn_packed(
            q, k_c, v_c, k_s, v_s, lengths,
            run=lambda *a, **kw: attn_packed_dispatch(
                *a, packed=packed, dispatch=cfg, bt=bt, leaf=leaf, **kw))
    name = leaf or "attn.kv"
    if bt is None:
        B, _, H, Dh = q.shape
        entry = None if cfg.mode == "twin" else _kernel_entry(
            _tuned_entry(cfg, "attn_packed", B, k_s.shape[1], H * Dh,
                         q.dtype, q.device, leaf=leaf,
                         container=None if packed else "int4"),
            q, name, "attn_packed")
        bt = entry.bt if entry is not None and entry.bt else ATTN_BT_DEFAULT
    bt = int(bt)
    if not use_kernel(cfg, q, name):
        return tiled_packed_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt,
                                      packed=packed, return_lse=return_lse)
    if not attn_packed_eligible(q.shape[-1], bt, packed):
        raise ValueError(
            f"{name}: the packed attention kernel needs a positive tile and, "
            f"for int4x2 codes, an even head dim; got Dh={q.shape[-1]}, "
            f"bt={bt}")
    return packed_decode_attention(q, k_c, v_c, k_s, v_s, lengths, bt=bt,
                                   packed=packed, name=name,
                                   return_lse=return_lse)


def attn_full_dispatch(
    q: torch.Tensor,        # (B, T, H, Dh)
    k: torch.Tensor,        # (B, T, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool,
    dispatch: Union[None, str, DispatchConfig] = None,
    leaf: Optional[str] = None,
) -> torch.Tensor:
    """Full-sequence attention, q's rows at positions 0..Tq-1 of k's (a
    sequence-sharded rank's at its query offset, below).  A CUDA tensor
    takes the ``flash_attention`` op under ``auto`` and ``kernel`` (a shape
    the kernel cannot take raises); ``twin``, and ``auto`` on the CPU, take
    :func:`repro_torch.models.layers.chunked_attention`, which is also what
    the op's backward recomputes.  Placed (DTensor) q, k, v run on each
    rank's local heads, or its local query rows when q is
    sequence-sharded (:func:`repro_torch.core.sharded.attn_full`), at
    their absolute positions: the rank's query offset goes to the kernel
    and to the op's recompute alike."""
    # imported here: models.layers imports this module
    from ..kernels.flash_attention.ops import flash_attention
    from ..models.layers import chunked_attention

    cfg = resolve(dispatch)
    name = leaf or "attn.full"

    def run(q, k, v, q_offset=0):
        if use_kernel(cfg, q, name) and q.is_cuda:
            return flash_attention(q, k, v, causal, q_offset)
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset)

    with named_range("attention.flash"):
        if sharded.any_dtensor(q, k, v):
            return sharded.attn_full(q, k, v, causal=causal, run=run)
        return run(q, k, v)


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
                          out_dtype=out_dtype, leaf=leaf, pool=pool,
                          M=x.shape[0] * Ho * Wo)


def fused_conv_entry(cfg: DispatchConfig, kind: str, cp: ConvPayload,
                     x: torch.Tensor, M: int, leaf: Optional[str],
                     container: Optional[str],
                     pattern: Optional[BlockSparsePattern] = None):
    """The tuned ``fusedconv_*`` entry of a fused conv call, looked up as
    the reference's fused convs do (no tuner writes these keys: the conv
    kernels keep their own route rule); one naming the plain version on a
    CUDA tensor raises."""
    return _kernel_entry(
        _tuned_entry(cfg, kind, M, cp.K, cp.N, x.dtype, x.device, pattern,
                     leaf, container), x, leaf, kind)


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
                         leaf=leaf, op="conv")
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
