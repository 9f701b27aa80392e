"""Architecture registry of the port: ``get_config(arch)`` and
``reduced_config(arch)``."""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeSpec", "get_config",
           "reduced_config"]

# the reference's registry, in its order (``repro.configs._MODULES``)
_MODULES = {
    "llama3-405b": "llama3_405b",
    "qwen1.5-4b": "qwen1_5_4b",
    "starcoder2-7b": "starcoder2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    key = arch if arch in _MODULES else arch.replace("_", "-")
    for k, m in _MODULES.items():
        if m == arch:
            key = k
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[key]}", __package__).CONFIG


def reduced_config(arch: str) -> ArchConfig:
    """Tiny same-family config for CPU runs and tests (a copy of
    ``repro.configs.reduced_config``)."""
    cfg = get_config(arch)
    small: dict = dict(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128,
        head_dim=16, param_dtype="float32", remat=False,
    )
    small["n_kv_heads"] = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    if cfg.family == "moe":
        small.update(n_experts=8, top_k=min(cfg.top_k, 4), d_expert=32,
                     n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family == "ssm":
        small.update(n_layers=cfg.slstm_every, slstm_every=cfg.slstm_every,
                     d_inner=128, d_ff=0, n_kv_heads=4)
    if cfg.family == "hybrid":
        small.update(n_layers=2 * 2, attn_every=2, d_inner=128, ssm_state=16,
                     n_kv_heads=4)
    if cfg.frontend == "patch":
        small.update(n_prefix_tokens=4)
    return dataclasses.replace(cfg, **small)
