"""int2 packed quant family: four 2-bit codes per byte along K.

Leaf form ``{"w_q2": (ceil(K/4), N) uint8, "w_s": (N,) f32}`` — the
quarter-byte sibling of the ``quant_packed`` int4x2 container.  Payload
form: :class:`repro_torch.core.quant.PackedTensor` with ``per_byte == 4``
and a K-axis container (an N-axis int2x4 container falls through to the
unpacked ``quant`` family, which unpacks it to the same int8 codes).

``quant_matmul`` / ``quant_conv`` decode the crumbs in registers when K
divides by 4 (``packed="int2x4"``: a quarter of the bytes per weight);
otherwise the codes are unpacked once and the int8 kernel runs — a kernel
either way on a CUDA tensor.

This module registers BEFORE :mod:`repro_torch.core.families.quant`
(container variants match ahead of their unpacked twins), so it imports
that module only at call time.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ..quant import (
    PACKED_CONTAINER_INT2,
    PackedTensor,
    QuantizedTensor,
    pack_codes,
    quantize,
    unpack_codes,
)

# ----------------------------------------------------------------- execute


def _apply_int2(p, x, *, pattern, cfg, bias, activation, compute_dtype,
                leaf, tag=""):
    # the container cannot tell K from K+1..K+3: the logical K comes from x
    del pattern
    wp = p["w_q2"]
    K, N = int(x.shape[-1]), int(wp.shape[-1])
    if wp.shape[-2] != -(-K // 4):
        raise ValueError(
            f"int2 container rows {wp.shape[-2]} do not match activation "
            f"K={K} (expected ceil(K/4)={-(-K // 4)}) — w_q2 leaves are "
            "packed four codes per byte along K")
    scales = p["w_s"].reshape(N)
    if K % 4 == 0:  # in-kernel crumb decode
        qt = PackedTensor(data=wp, shape=(K, N), axis=0, scales=scales,
                          bits=2, per_byte=4)
    else:  # the int8 codes, unpacked once
        qt = QuantizedTensor(
            values=_d.derived(wp, f"int2_codes_{K}", wp.device,
                              lambda: unpack_codes(wp, K, axis=0, bits=2)),
            scales=scales, axis=1, bits=2)
    return _d.quant_linear(x, qt, bias=bias, activation=activation,
                           out_dtype=compute_dtype,
                           use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                           plan=_d.tuned_plan(cfg, tag + "quant", x, K, N,
                                              leaf=leaf,
                                              container=PACKED_CONTAINER_INT2))


# ------------------------------------------------------------------ payload


def _matches(payload):
    return isinstance(payload, PackedTensor) and payload.per_byte == 4 \
        and payload.axis % len(payload.shape) == 0


def _from_payload(payload):
    if not _matches(payload):
        return None
    K, N = payload.shape
    return {"w_q2": payload.data, "w_s": payload.scales.reshape(N)}, None


def _payload_dense(payload):
    K, N = payload.shape
    return payload.unpack().to(torch.float32) * \
        payload.scales.reshape(N).to(torch.float32)[None, :]


# --------------------------------------------------------------- fused conv


def _conv_fused(cp, x, *, cfg, bias, activation, out_dtype, leaf, pool, M):
    # the int4x2 conv entry reads the payload's own per_byte / container:
    # crumbs decoded in the kernel when K divides by 4, else int8 codes
    from .quant import _conv_fused as _quant_conv_fused

    return _quant_conv_fused(cp, x, cfg=cfg, bias=bias, activation=activation,
                             out_dtype=out_dtype, leaf=leaf, pool=pool, M=M)


def _tune_prepare(leaves, pattern, K):
    """Timed packed, in the kernel (the quant family's runner takes the
    int2x4 container as it is)."""
    del pattern, K
    return dict(leaves), PACKED_CONTAINER_INT2


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    # the logical K comes from the report's (K, N) shape
    from .quant import _decompress as _quant_decompress

    assert shape is not None, "int2 quant leaf without a report shape"
    w_q = unpack_codes(leaf["w_q2"], shape[0], axis=-2, bits=2)
    leaf = {**{k: v for k, v in leaf.items() if k != "w_q2"}, "w_q": w_q}
    return _quant_decompress(leaf, pattern=pattern, shape=shape, dtype=dtype)


# ------------------------------------------------------------------ samples


def _validate(p, pattern):
    del pattern
    w, s = p.get("w_q2"), p.get("w_s")
    if w is not None and s is not None and s.shape[-1] != w.shape[-1]:
        raise ValueError(
            f"int2 payload: scale leaf 'w_s' has {s.shape[-1]} channels "
            f"but container 'w_q2' has N={w.shape[-1]} output columns "
            f"(shapes {tuple(s.shape)} vs {tuple(w.shape)}) — stale "
            "scales from a different compile would dequantise wrong")


def _sample(rng: np.random.Generator):
    qt = quantize(torch.as_tensor(rng.normal(size=(16, 8)),
                                  dtype=torch.float32), 2, axis=1)
    return {"w_q2": pack_codes(qt.values, axis=0, bits=2),
            "w_s": qt.scales.reshape(8).to(torch.float32)}, None


FAMILY = _reg.register(_reg.PayloadFamily(
    name="int2",
    key_leaf="w_q2",
    leaf_names=("w_q2", "w_s"),
    apply=_apply_int2,
    kind="quant",
    container=PACKED_CONTAINER_INT2,
    matches=_matches,
    from_payload=_from_payload,
    conv_fused=_conv_fused,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=lambda payload: tuple(map(int, payload.shape)),
    tune_prepare=_tune_prepare,
    leaf_ndim={"w_q2": 2, "w_s": 1},
    container_leaves=("w_q2",),
    sample=_sample,
    validate=_validate,
))
