"""Dense family — a plain matmul is the engine-free form.

Leaf form ``{"w": (K, N)}``; the payload form is a plain (possibly masked)
tensor.  No kernel and no container: ``torch.matmul`` in the compute dtype,
as the JAX package leaves this product to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ._util import he_init


def _apply(p, x, *, pattern, cfg, bias, activation, compute_dtype, leaf,
           tag=""):
    del tag  # never tuned
    del pattern, cfg, leaf
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    return _d._epilogue(y, bias, activation, compute_dtype)


def _from_payload(payload):
    if not isinstance(payload, torch.Tensor):
        return None
    return {"w": payload}, None


def _matches(payload):
    return isinstance(payload, torch.Tensor)


def _payload_dense(payload):
    return payload.to(torch.float32)


def _payload_kn(payload):
    return tuple(map(int, payload.shape))


def _init_dense(gen, K, N, *, dtype, pattern, lead):
    del pattern
    return {"w": he_init(gen, lead + (K, N), dtype, K)}


def _sample(rng: np.random.Generator):
    return {"w": torch.as_tensor(rng.normal(size=(16, 8)), dtype=torch.float32)}, \
        None


FAMILY = _reg.register(_reg.PayloadFamily(
    name="dense",
    key_leaf="w",
    leaf_names=("w",),
    apply=_apply,
    matches=_matches,
    from_payload=_from_payload,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    leaf_ndim={"w": 2},
    sample=_sample,
    init_modes={"dense": _init_dense},
))
