"""Per-output-channel quant families: int8 codes and the bit-packed int4
container, plus the ``"quant"`` policy compiler.

Leaf forms:

* ``quant``        — ``{"w_q": (K, N) int8, "w_s": (N,) f32}``
* ``quant_packed`` — ``{"w_qp": (ceil(K/2), N) uint8, "w_s": (N,) f32}``
  (two 4-bit codes per byte along K; the logical K comes from the
  activation)

Payload forms: :class:`QuantizedTensor` and :class:`PackedTensor`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ._util import fan_in_scales, int8_codes
from ..quant import (
    PACKED_CONTAINER,
    PACKED_CONTAINER_INT2,
    PackedTensor,
    QuantizedTensor,
    pack_codes,
    pack_int4,
    pack_quantized,
    quantize,
    unpack_codes,
    unpack_int4,
)


def _apply_quant(p, x, *, pattern, cfg, bias, activation, compute_dtype,
                 leaf, tag=""):
    del pattern
    K, N = (int(d) for d in p["w_q"].shape[-2:])
    qt = QuantizedTensor(values=p["w_q"], scales=p["w_s"].reshape(N), axis=1,
                         bits=8)
    return _d.quant_linear(x, qt, bias=bias, activation=activation,
                           out_dtype=compute_dtype,
                           use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                           plan=_d.tuned_plan(cfg, tag + "quant", x, K, N,
                                              leaf=leaf))


def _apply_quant_packed(p, x, *, pattern, cfg, bias, activation,
                        compute_dtype, leaf, tag=""):
    # the container cannot tell K from K+1 when K is odd: K comes from x
    del pattern
    wp = p["w_qp"]
    K, N = int(x.shape[-1]), int(wp.shape[-1])
    if wp.shape[-2] != (K + 1) // 2:
        raise ValueError(
            f"packed quant container rows {wp.shape[-2]} do not match "
            f"activation K={K} (expected ceil(K/2)={(K + 1) // 2}) — "
            "w_qp leaves are packed two codes per byte along K")
    pt = PackedTensor(data=wp, shape=(K, N), axis=0,
                      scales=p["w_s"].reshape(N), bits=4, per_byte=2)
    return _d.quant_linear(x, pt, bias=bias, activation=activation,
                           out_dtype=compute_dtype,
                           use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                           plan=_d.tuned_plan(cfg, tag + "quant", x, K, N,
                                              leaf=leaf,
                                              container=PACKED_CONTAINER))


# ------------------------------------------------------------------ payload


def _matches_packed(payload):
    # int4x2 only: four-per-byte (int2x4) K-axis containers belong to the
    # int2 family, which registers ahead of this module
    return isinstance(payload, PackedTensor) and payload.per_byte == 2 \
        and payload.axis % len(payload.shape) == 0


def _from_payload_packed(payload):
    if not _matches_packed(payload):
        return None
    K, N = payload.shape
    return {"w_qp": payload.data, "w_s": payload.scales.reshape(N)}, None


def _matches(payload):
    return isinstance(payload, (PackedTensor, QuantizedTensor))


def _from_payload(payload):
    if isinstance(payload, PackedTensor):
        # an N-axis container (odd K) unpacks to the int8 codes
        K, N = payload.shape
        return {"w_q": payload.unpack(), "w_s": payload.scales.reshape(N)}, \
            None
    if isinstance(payload, QuantizedTensor):
        K, N = payload.values.shape
        return {"w_q": payload.values, "w_s": payload.scales.reshape(N)}, None
    return None


def _payload_dense(payload):
    """(K, N) f32: the codes times the per-output-channel scales."""
    if isinstance(payload, PackedTensor):
        K, N = payload.shape
        codes = payload.unpack()
    else:
        K, N = payload.values.shape
        codes = payload.values
    return codes.to(torch.float32) * \
        payload.scales.reshape(N).to(torch.float32)[None, :]


def _payload_kn(payload):
    if isinstance(payload, PackedTensor):
        return tuple(map(int, payload.shape))
    return tuple(map(int, payload.values.shape))


# --------------------------------------------------------------- fused conv


def _conv_fused(cp, x, *, cfg, bias, activation, out_dtype, leaf, pool, M):
    """The quant_conv entry (patches gathered in the kernel, pooled emit)
    over a pre-padded VALID input; shared by the int8 and packed payload
    forms.  ``twin`` returns None: the caller takes the im2col leg.  The
    ``fusedconv_quant`` tuned lookup is the reference's (M = B·Ho·Wo)."""
    if not _d.use_kernel(cfg, x, leaf):
        return None
    payload = cp.payload
    _d.fused_conv_entry(cfg, "fusedconv_quant", cp, x, M, leaf,
                        getattr(payload, "container", None)
                        if isinstance(payload, PackedTensor) else None)
    K, N = cp.K, cp.N
    packed = False
    if isinstance(payload, PackedTensor):
        if payload.axis % len(payload.shape) == 0 \
                and K % payload.per_byte == 0:
            w_q, packed = payload.data, payload.container
        else:  # an N-axis container (odd K): the int8 codes, unpacked once
            w_q = _d.derived(payload, "codes", x.device, payload.unpack)
    else:
        w_q = payload.values
    return _d.quant_conv(
        x.to(out_dtype).contiguous(), w_q, payload.scales.reshape(N), bias,
        kernel_hw=cp.kernel[:2], activation=activation, strides=cp.strides,
        dilation=cp.dilation, pool=pool, packed=packed,
        name=leaf or "quant_conv")


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    del pattern, shape
    w_q, w_s = leaf["w_q"], leaf["w_s"]
    w = w_q.to(torch.float32) * (
        w_s[..., None, :] if w_q.ndim == 3 else w_s[None, :])
    out = {k: v for k, v in leaf.items() if k not in ("w_q", "w_s")}
    out["w"] = w.to(dtype)
    return out


def _decompress_packed(leaf, *, pattern, shape, dtype):
    # the logical K comes from the report's (K, N) shape
    assert shape is not None, "packed quant leaf without a report shape"
    w_q = unpack_int4(leaf["w_qp"], shape[0], axis=-2)
    leaf = {**{k: v for k, v in leaf.items() if k != "w_qp"}, "w_q": w_q}
    return _decompress(leaf, pattern=pattern, shape=shape, dtype=dtype)


# ----------------------------------------------------------------- autotune


def _tune_prepare(leaves, pattern, K):
    """A packed container is timed packed, in its kernel: the leaves as
    they are, and the container tag of their keys."""
    del pattern, K
    return dict(leaves), PACKED_CONTAINER


def _tune_operands(x, leaves):
    """(x, codes or container, scales, packed tag) as the family's apply
    hands them to ``quant_matmul``: a container packed along K (K a
    multiple of its codes a byte) in its kernel, else its int8 codes."""
    K = int(x.shape[-1])
    for name, per_byte, tag in (("w_qp", 2, PACKED_CONTAINER),
                                ("w_q2", 4, PACKED_CONTAINER_INT2)):
        if name in leaves:
            w = leaves[name]
            if K % per_byte:
                return x, unpack_codes(w, K, axis=0, bits=8 // per_byte), \
                    leaves["w_s"], False
            return x, w, leaves["w_s"], tag
    return x, leaves["w_q"], leaves["w_s"], False


def _tune_candidates(x, leaves, pattern):
    from ...kernels.quant_matmul.kernel import qmm_candidates
    from ...kernels.sparse_matmul.kernel import packed_ratio

    del pattern
    x, w, _, packed = _tune_operands(x, leaves)
    M, K = x.shape
    return qmm_candidates(M, K, int(w.shape[-1]), packed_ratio(packed),
                          x.dtype == torch.bfloat16, w.data_ptr(),
                          x.data_ptr())


def _tune_runner(cand, x, leaves, pattern):
    """One candidate ``(route, plan)`` on ``quant_matmul``, or the plain
    version (None), on the operands of :func:`_tune_operands`."""
    from ...kernels.quant_matmul.kernel import quant_matmul
    from ...kernels.quant_matmul.ref import quant_matmul_ref

    del pattern
    x, w, s, packed = _tune_operands(x, leaves)
    N = int(w.shape[-1])
    s = s.reshape(N).to(torch.float32)
    if cand is None:
        codes = unpack_codes(w, int(x.shape[-1]), axis=0,
                             bits=4 if packed == PACKED_CONTAINER else 2) \
            if packed else w
        return lambda: quant_matmul_ref(x, codes, s, out_dtype=x.dtype)
    return lambda: quant_matmul(x, w, s, packed=packed, plan=cand,
                                name="autotune")


def _leaf_kn(leaves, pattern):
    """(K, N) of quant leaves; a packed container's K is its rows times
    its codes a byte (the tuner takes the logical K from x)."""
    del pattern
    for name, per_byte in (("w_q", 1), ("w_qp", 2), ("w_q2", 4)):
        if name in leaves:
            rows, N = (int(d) for d in leaves[name].shape[-2:])
            return rows * per_byte, N
    raise ValueError(f"no quant code leaf in {sorted(leaves)}")


# ------------------------------------------------------------------- policy


def _quantize_stack(stack: np.ndarray, bits: int):
    """(L, K, N) -> w_q (L, K, N) int8, w_s (L, N) f32 per-out-channel."""
    qs, ss = [], []
    for wl in stack:
        qt = quantize(torch.from_numpy(np.ascontiguousarray(wl)), bits, axis=1)
        qs.append(qt.values)
        ss.append(qt.scales.reshape(-1))
    return torch.stack(qs), torch.stack(ss).to(torch.float32)


def _compile_stack(stack, masks, *, pattern, bits, rules):
    """Quantise an (L, K, N) stack: 8-bit ``{"w_q", "w_s"}``; 3/4-bit codes
    bit-packed two per byte along K into ``{"w_qp", "w_s"}``; <=2-bit codes
    four per byte into the int2 family's ``{"w_q2", "w_s"}`` when K divides
    by 4 (else the int4x2 container, exact either way).  Returns (leaves,
    code_bytes, container_bytes, None)."""
    del pattern, rules
    masked = stack if masks is None else stack * masks
    w_q, w_s = _quantize_stack(masked, bits)
    code_bytes = int(w_q.numel() + w_s.numel() * 4)
    if bits <= 2 and stack.shape[1] % 4 == 0:
        w_q2 = pack_codes(w_q, axis=1, bits=2)
        return {"w_q2": w_q2, "w_s": w_s}, code_bytes, \
            int(w_q2.numel() + w_s.numel() * 4), None
    if bits <= 4:
        w_qp = pack_int4(w_q, axis=1)
        leaves = {"w_qp": w_qp, "w_s": w_s}
        return leaves, code_bytes, int(w_qp.numel() + w_s.numel() * 4), None
    return {"w_q": w_q, "w_s": w_s}, code_bytes, code_bytes, None


def _compile_payload(w, mask, *, bits, rules, block):
    """One (K, N) weight to a :class:`QuantizedTensor` payload, or at
    <= 4 bits its bit-packed :class:`PackedTensor` (int4x2, or int2x4 at
    <= 2 bits).  Returns (payload, None, code_bytes, container_bytes, None,
    None)."""
    del rules, block
    K, N = w.shape
    qt = quantize(torch.from_numpy(w if mask is None else w * mask), bits,
                  axis=1)
    qt = QuantizedTensor(values=qt.values, scales=qt.scales.reshape(N),
                         axis=1, bits=bits)
    comp_bytes = cont_bytes = K * N + N * 4
    if bits <= 4:  # bit-packed container: two (int4x2) or four codes a byte
        payload = pack_quantized(qt)
        cont_bytes = payload.container_bytes
    else:
        payload = qt
    return payload, None, comp_bytes, cont_bytes, None, None


# ------------------------------------------------------------------ samples


def _validate_scales(name: str, key_leaf: str):
    """The per-output-channel scales must match the code leaf's N axis."""

    def validate(p, pattern):
        del pattern
        w, s = p.get(key_leaf), p.get("w_s")
        if w is None or s is None:
            return
        if s.shape[-1] != w.shape[-1]:
            raise ValueError(
                f"{name} payload: scale leaf 'w_s' has {s.shape[-1]} "
                f"channels but code leaf {key_leaf!r} has N="
                f"{w.shape[-1]} output columns (shapes {tuple(s.shape)} "
                f"vs {tuple(w.shape)}) — stale scales from a different "
                "compile would dequantise silently wrong")

    return validate


def _sample(rng):
    qt = quantize(torch.as_tensor(rng.normal(size=(16, 8)), dtype=torch.float32),
                  8, axis=1)
    return {"w_q": qt.values, "w_s": qt.scales.reshape(8)}, None


def _sample_packed(rng):
    qt = quantize(torch.as_tensor(rng.normal(size=(16, 8)), dtype=torch.float32),
                  4, axis=1)
    return {"w_qp": pack_int4(qt.values, axis=0),
            "w_s": qt.scales.reshape(8)}, None


PACKED_FAMILY = _reg.register(_reg.PayloadFamily(
    name="quant_packed",
    key_leaf="w_qp",
    leaf_names=("w_qp", "w_s"),
    apply=_apply_quant_packed,
    kind="quant",
    container=PACKED_CONTAINER,
    matches=_matches_packed,
    from_payload=_from_payload_packed,
    conv_fused=_conv_fused,
    decompress=_decompress_packed,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    tune_prepare=_tune_prepare,
    leaf_ndim={"w_qp": 2, "w_s": 1},
    container_leaves=("w_qp",),
    sample=_sample_packed,
    validate=_validate_scales("quant_packed", "w_qp"),
))

def _init_int8(gen, K, N, *, dtype, pattern, lead):
    # near-zero-symmetric codes; the scales are set for recalibration
    del dtype, pattern
    return {"w_q": int8_codes(gen, lead + (K, N)),
            "w_s": fan_in_scales(gen, lead + (N,), K)}


FAMILY = _reg.register(_reg.PayloadFamily(
    name="quant",
    key_leaf="w_q",
    leaf_names=("w_q", "w_s"),
    apply=_apply_quant,
    kind="quant",
    matches=_matches,
    from_payload=_from_payload,
    conv_fused=_conv_fused,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    tune_candidates=_tune_candidates,
    tune_runner=_tune_runner,
    leaf_kn=_leaf_kn,
    leaf_ndim={"w_q": 2, "w_s": 1},
    sample=_sample,
    validate=_validate_scales("quant", "w_q"),
    init_modes={"int8": _init_int8},
))

POLICY = _reg.register_policy(_reg.PolicyCompiler(
    name="quant",
    compile_stack=_compile_stack,
    compile_payload=_compile_payload,
))
