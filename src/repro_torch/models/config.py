"""Architecture configuration — one instance per config file.

The fields of ``repro.models.config.ArchConfig`` that the port's dense
family reads, under the same names, so a configuration reads the same in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # the port runs "dense"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"       # swiglu | gelu
    norm: str = "rms"         # rms | ln
    causal: bool = True
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    remat: bool = True        # forward recomputes each layer in backward
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
