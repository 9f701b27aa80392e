"""Per-INPUT-channel-scale quant family.

Symmetric int8 (or int4-range) codes with one f32 scale per *input*
channel (the K axis), the transposed twin of the ``quant`` family's
per-output-channel scales:

    W = diag(s) @ W_q          =>   x @ W = (x * s) @ W_q

Leaf form ``{"w_pc": (K, N) int8, "w_pcs": (K,) f32}``; payload form
:class:`PerChannelQuant`.  The scale folds into the activation in the
compute dtype before the product (:func:`repro_torch.core.dispatch.
perchannel_fold`, one rounding as the reference's), so the kernel leg is
``quant_matmul`` with unit output scales — no new kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ._util import fan_in_scales, int8_codes
from ..quant import QuantizedTensor, quantize


@dataclasses.dataclass
class PerChannelQuant:
    """Payload form: int8 codes + per-input-channel (K,) f32 scales."""

    values: torch.Tensor   # (K, N) int8 codes
    scales: torch.Tensor   # (K,) f32 per-input-channel
    bits: int = 8

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape)

    def dequantize(self) -> torch.Tensor:
        K = self.values.shape[-2]
        return self.values.to(torch.float32) * \
            self.scales.reshape(K).to(torch.float32)[:, None]


def quantize_per_channel(w, bits: int = 8) -> PerChannelQuant:
    """Symmetric quantisation with one scale per input channel (K axis)."""
    qt = quantize(torch.as_tensor(np.ascontiguousarray(w)), bits, axis=0)
    K = qt.values.shape[0]
    return PerChannelQuant(values=qt.values,
                           scales=qt.scales.reshape(K).to(torch.float32),
                           bits=bits)


# ----------------------------------------------------------------- execute


# the container tag of this family's tuned keys (the reference's)
PERCHANNEL_CONTAINER = "perchannel"


def _apply(p, x, *, pattern, cfg, bias, activation, compute_dtype, leaf,
           tag=""):
    del pattern
    w = p["w_pc"]
    K, N = (int(d) for d in w.shape[-2:])
    xs = _d.perchannel_fold(x, p["w_pcs"], compute_dtype)
    qt = QuantizedTensor(values=w, scales=_d.unit_scales(N, x.device),
                         axis=1, bits=8)
    return _d.quant_linear(xs, qt, bias=bias, activation=activation,
                           out_dtype=compute_dtype,
                           use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                           plan=_d.tuned_plan(cfg, tag + "quant", x, K, N,
                                              leaf=leaf,
                                              container=PERCHANNEL_CONTAINER))


# ------------------------------------------------------------------ payload


def _matches(payload):
    return isinstance(payload, PerChannelQuant)


def _from_payload(payload):
    if not _matches(payload):
        return None
    K = payload.values.shape[0]
    return {"w_pc": payload.values, "w_pcs": payload.scales.reshape(K)}, None


def _payload_dense(payload):
    return payload.dequantize()


def _payload_kn(payload):
    return tuple(map(int, payload.values.shape))


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    del pattern, shape
    # scales broadcast over the K axis; stacked leaves carry (L, K)
    w = leaf["w_pc"].to(torch.float32) * leaf["w_pcs"][..., :, None]
    out = {k: v for k, v in leaf.items() if k not in ("w_pc", "w_pcs")}
    out["w"] = w.to(dtype)
    return out


# ------------------------------------------------------------------- policy


def _compile_stack(stack, masks, *, pattern, bits, rules):
    del pattern, rules
    masked = stack if masks is None else stack * masks
    pcqs = [quantize_per_channel(wl, bits) for wl in masked]
    w_pc = torch.stack([q.values for q in pcqs])
    w_pcs = torch.stack([q.scales.reshape(-1) for q in pcqs])
    code_bytes = int(w_pc.numel() + w_pcs.numel() * 4)
    return {"w_pc": w_pc, "w_pcs": w_pcs}, code_bytes, code_bytes, None


def _compile_payload(w, mask, *, bits, rules, block):
    del rules, block
    K, N = w.shape
    pcq = quantize_per_channel(w if mask is None else w * mask, bits)
    comp_bytes = cont_bytes = K * N + K * 4
    return pcq, None, comp_bytes, cont_bytes, None, None


# ------------------------------------------------------------------ samples


def _validate(p, pattern):
    del pattern
    w, s = p.get("w_pc"), p.get("w_pcs")
    if w is not None and s is not None and s.shape[-1] != w.shape[-2]:
        raise ValueError(
            f"perchannel payload: scale leaf 'w_pcs' has {s.shape[-1]} "
            f"channels but code leaf 'w_pc' has K={w.shape[-2]} input "
            f"rows (shapes {tuple(s.shape)} vs {tuple(w.shape)}) — "
            "per-INPUT-channel scales must match the K axis")


def _sample(rng: np.random.Generator):
    pcq = quantize_per_channel(
        rng.normal(size=(16, 8)).astype(np.float32), 8)
    return {"w_pc": pcq.values, "w_pcs": pcq.scales}, None


def _init_perchannel_int8(gen, K, N, *, dtype, pattern, lead):
    del dtype, pattern
    return {"w_pc": int8_codes(gen, lead + (K, N)),
            "w_pcs": fan_in_scales(gen, lead + (K,), K)}


FAMILY = _reg.register(_reg.PayloadFamily(
    name="perchannel",
    key_leaf="w_pc",
    leaf_names=("w_pc", "w_pcs"),
    apply=_apply,
    matches=_matches,
    from_payload=_from_payload,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    leaf_ndim={"w_pc": 2, "w_pcs": 1},
    # int8 codes: stored verbatim, never widened by the checkpointer
    container_leaves=("w_pc",),
    shard_tails={"w_pc": "replicate", "w_pcs": "replicate"},
    sample=_sample,
    validate=_validate,
    init_modes={"perchannel_int8": _init_perchannel_int8},
))

POLICY = _reg.register_policy(_reg.PolicyCompiler(
    name="perchannel",
    compile_stack=_compile_stack,
    compile_payload=_compile_payload,
))
