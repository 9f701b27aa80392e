"""Shape-only stand-ins for every model input, as trees of
``torch.device("meta")`` tensors: the counterpart of the reference's
``jax.ShapeDtypeStruct`` specs (``repro.launch.specs``).  Nothing is
allocated.  The parameter and cache trees come from the same code that
builds the real ones (:func:`repro_torch.models.model.init_params` /
``init_cache`` on ``"meta"``), so their shapes cannot drift from it; the
dry-run (:mod:`repro_torch.launch.dryrun`) places them on a mesh and runs a
step on them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.config import ArchConfig, ShapeSpec
from ..models.model import init_cache, init_params
from ..train.optimizer import AdamWConfig, adamw_init

__all__ = ["cache_shapes", "input_specs", "opt_shapes", "param_shapes"]

PyTree = Any
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Batch input specs for one (arch × input-shape) cell."""
    B, T = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    if shape.kind == "train":
        if cfg.frontend == "frame":
            return {"frame_embeds": _sds((B, T, cfg.d_model), dt),
                    "labels": _sds((B, T), torch.int32)}
        batch = {"tokens": _sds((B, T), torch.int32),
                 "labels": _sds((B, T), torch.int32)}
        if cfg.frontend == "patch":
            batch["prefix_embeds"] = _sds((B, cfg.n_prefix_tokens,
                                           cfg.d_model), dt)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend == "frame":
            return {"frame_embeds": _sds((B, T, cfg.d_model), dt)}
        batch = {"tokens": _sds((B, T), torch.int32)}
        if cfg.frontend == "patch":
            batch["prefix_embeds"] = _sds((B, cfg.n_prefix_tokens,
                                           cfg.d_model), dt)
        return batch
    if shape.kind == "decode":
        return {"tokens": _sds((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def param_shapes(cfg: ArchConfig) -> PyTree:
    return init_params(cfg, device=META)


def opt_shapes(cfg: ArchConfig, params: PyTree,
               opt_cfg: AdamWConfig) -> PyTree:
    return adamw_init(params, opt_cfg)


def cache_shapes(cfg: ArchConfig, shape: ShapeSpec) -> PyTree:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
