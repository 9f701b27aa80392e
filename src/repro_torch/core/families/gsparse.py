"""Group-diagonal static sparsity family (plain torch).

Leaf form ``{"w_grp": (s, Kg, Ng) [, "w_s": (N,) f32]}``: output column
group c reads input row group ``(s - c) % s``, so the layer factorises
into s dense products (:func:`repro_torch.core.dispatch.gsparse_apply`),
which the reference, too, computes outside any kernel.  There is no
payload form and no policy compiler: gsparse weights exist only as leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ._util import fan_in_scales, he_init, int8_codes


def _apply(p, x, *, pattern, cfg, bias, activation, compute_dtype, leaf,
           tag=""):
    del tag  # never tuned
    del pattern, cfg, leaf
    y = _d.gsparse_apply(p["w_grp"], p.get("w_s"), x, compute_dtype)
    return _d._epilogue(y, bias, activation, compute_dtype)


def _validate(p, pattern):
    del pattern
    w, s = p.get("w_grp"), p.get("w_s")
    if w is not None and s is not None \
            and s.shape[-1] != w.shape[-3] * w.shape[-1]:
        raise ValueError(
            f"gsparse payload: scale leaf 'w_s' has {s.shape[-1]} "
            f"channels but 'w_grp' {tuple(w.shape)} factorises to "
            f"N={w.shape[-3] * w.shape[-1]} output columns (s groups x "
            "Ng each) — stale scales from a different group count")


def _init_gsparse(gen, K, N, *, dtype, pattern, lead):
    assert pattern is not None  # the group count s
    s = pattern
    return {"w_grp": he_init(gen, lead + (s, K // s, N // s), dtype, K // s)}


def _init_gsparse_int8(gen, K, N, *, dtype, pattern, lead):
    del dtype
    assert pattern is not None
    s = pattern
    return {"w_grp": int8_codes(gen, lead + (s, K // s, N // s)),
            "w_s": fan_in_scales(gen, lead + (N,), K // s)}


def _sample(rng: np.random.Generator):
    return {"w_grp": torch.as_tensor(rng.normal(size=(2, 8, 4)),
                                     dtype=torch.float32)}, None


FAMILY = _reg.register(_reg.PayloadFamily(
    name="gsparse",
    key_leaf="w_grp",
    leaf_names=("w_grp", "w_s"),
    apply=_apply,
    leaf_ndim={"w_grp": 3, "w_s": 1},
    # float groups, or int8 codes with w_s scales
    leaf_dtype_kinds={"w_grp": "fi"},
    sample=_sample,
    validate=_validate,
    init_modes={"gsparse": _init_gsparse,
                "gsparse_int8": _init_gsparse_int8},
))
