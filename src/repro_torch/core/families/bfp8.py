"""BFP8 family: block-floating-point — int8 mantissas sharing one
power-of-two exponent per output channel.

Leaf form ``{"w_bfp": (K, N) int8, "w_bfpe": (N,) int8}``; payload form
:class:`BFP8Tensor`.  The dequant scale of column n is exactly
``2 ** w_bfpe[n]`` — one byte per channel, and the multiply is an exact
binary shift.  The kernel leg is ``quant_matmul`` with ``exp2(e)`` as its
per-output-channel scale vector — no new kernel.

BFP8 is a fixed-mantissa format: the stored codes are always 8-bit
whatever bit-width the compile rules name; the accounting reports what
the format pays (1-byte mantissas, 1-byte exponents).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ._util import int8_codes
from ..quant import QuantizedTensor


@dataclasses.dataclass
class BFP8Tensor:
    """Payload form: int8 mantissas + per-output-channel int8 exponents."""

    mantissas: torch.Tensor  # (K, N) int8
    exponents: torch.Tensor  # (N,) int8 — column scale is exactly 2**e

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.mantissas.shape)

    def dequantize(self) -> torch.Tensor:
        N = self.mantissas.shape[-1]
        scales = torch.exp2(self.exponents.reshape(N).to(torch.float32))
        return self.mantissas.to(torch.float32) * scales[None, :]


def quantize_bfp8(w) -> BFP8Tensor:
    """Shared-exponent quantisation: one power-of-two scale per column.

    ``e = ceil(log2(amax / 127))`` puts every mantissa in [-127, 127]; an
    all-zero column stores ``e = 0`` with zero mantissas.  Host numpy, as
    the reference, so the bytes match it.
    """
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    with np.errstate(divide="ignore"):
        e = np.where(amax > 0.0, np.ceil(np.log2(amax / 127.0)), 0.0)
    e = np.clip(e, -126, 127).astype(np.int8)
    scale = np.exp2(e.astype(np.float32))
    m = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return BFP8Tensor(mantissas=torch.from_numpy(m),
                      exponents=torch.from_numpy(e))


# ----------------------------------------------------------------- execute


# the container tag of this family's tuned keys (the reference's)
BFP8_CONTAINER = "bfp8"


def _apply(p, x, *, pattern, cfg, bias, activation, compute_dtype, leaf,
           tag=""):
    del pattern
    K, N = (int(d) for d in p["w_bfp"].shape[-2:])
    # the exponent folds at the emit step: the kernel's per-output-channel
    # scale vector is exactly 2**e
    qt = QuantizedTensor(values=p["w_bfp"],
                         scales=torch.exp2(p["w_bfpe"].to(torch.float32)),
                         axis=1, bits=8)
    return _d.quant_linear(x, qt, bias=bias, activation=activation,
                           out_dtype=compute_dtype,
                           use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                           plan=_d.tuned_plan(cfg, tag + "quant", x, K, N,
                                              leaf=leaf,
                                              container=BFP8_CONTAINER))


# ------------------------------------------------------------------ payload


def _matches(payload):
    return isinstance(payload, BFP8Tensor)


def _from_payload(payload):
    if not _matches(payload):
        return None
    N = payload.mantissas.shape[-1]
    return {"w_bfp": payload.mantissas,
            "w_bfpe": payload.exponents.reshape(N)}, None


def _payload_dense(payload):
    return payload.dequantize()


def _payload_kn(payload):
    return tuple(map(int, payload.mantissas.shape))


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    del pattern, shape
    # exact: the scale is a power of two; stacked leaves carry (L, N)
    w = leaf["w_bfp"].to(torch.float32) * torch.exp2(
        leaf["w_bfpe"].to(torch.float32))[..., None, :]
    out = {k: v for k, v in leaf.items() if k not in ("w_bfp", "w_bfpe")}
    out["w"] = w.to(dtype)
    return out


# ------------------------------------------------------------------- policy


def _compile_stack(stack, masks, *, pattern, bits, rules):
    # ``bits`` names the operating point; the stored codes are always 8-bit
    del pattern, bits, rules
    masked = stack if masks is None else stack * masks
    ts = [quantize_bfp8(wl) for wl in masked]
    w_bfp = torch.stack([t.mantissas for t in ts])
    w_bfpe = torch.stack([t.exponents for t in ts])
    code_bytes = int(w_bfp.numel() + w_bfpe.numel())
    return {"w_bfp": w_bfp, "w_bfpe": w_bfpe}, code_bytes, code_bytes, None


def _compile_payload(w, mask, *, bits, rules, block):
    del bits, rules, block
    K, N = w.shape
    t = quantize_bfp8(w if mask is None else w * mask)
    comp_bytes = cont_bytes = K * N + N
    return t, None, comp_bytes, cont_bytes, None, None


# ------------------------------------------------------------------ samples


def _validate(p, pattern):
    del pattern
    w, e = p.get("w_bfp"), p.get("w_bfpe")
    if w is not None and e is not None and e.shape[-1] != w.shape[-1]:
        raise ValueError(
            f"bfp8 payload: exponent leaf 'w_bfpe' has {e.shape[-1]} "
            f"channels but mantissa leaf 'w_bfp' has N={w.shape[-1]} "
            f"output columns (shapes {tuple(e.shape)} vs "
            f"{tuple(w.shape)}) — stale exponents rescale every column")


def _sample(rng: np.random.Generator):
    t = quantize_bfp8(rng.normal(size=(16, 8)).astype(np.float32))
    return {"w_bfp": t.mantissas, "w_bfpe": t.exponents}, None


def _init_bfp8(gen, K, N, *, dtype, pattern, lead):
    del dtype, pattern
    return {"w_bfp": int8_codes(gen, lead + (K, N)),
            "w_bfpe": torch.full(lead + (N,), -10, dtype=torch.int8,
                                 device=gen.device)}


FAMILY = _reg.register(_reg.PayloadFamily(
    name="bfp8",
    key_leaf="w_bfp",
    leaf_names=("w_bfp", "w_bfpe"),
    apply=_apply,
    matches=_matches,
    from_payload=_from_payload,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    leaf_ndim={"w_bfp": 2, "w_bfpe": 1},
    # int8 mantissas: stored verbatim, never widened by the checkpointer
    container_leaves=("w_bfp",),
    shard_tails={"w_bfp": "replicate", "w_bfpe": "replicate"},
    sample=_sample,
    validate=_validate,
    init_modes={"bfp8": _init_bfp8},
))

POLICY = _reg.register_policy(_reg.PolicyCompiler(
    name="bfp8",
    compile_stack=_compile_stack,
    compile_payload=_compile_payload,
))
