"""Architecture configuration — one instance per config file — and the
input shapes (``SHAPES``) the layer IR and the DSE are run at.

The fields of ``repro.models.config.ArchConfig`` that the port's
families (dense, encoder, VLM, MoE, SSM, hybrid) read, under the same
names, so a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encoder | vlm
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

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_variant: str = ""     # mlstm | mamba2
    ssm_state: int = 0
    slstm_every: int = 0      # xLSTM: every k-th block is sLSTM
    attn_every: int = 0       # zamba2: shared attention block every k layers
    d_inner: int = 0          # ssm inner width (default 2*d_model)

    # VLM / audio stub frontend
    n_prefix_tokens: int = 0  # image/audio embeddings prepended (stub)
    frontend: str = ""        # 'patch' (vlm) | 'frame' (audio encoder input)

    # LogicSparse datapath of the synthetic init (models.blocks.lin_init)
    linear_mode: str = "dense"        # an init mode of a payload family
    sparse_block: Tuple[int, int] = (128, 128)
    sparse_density: float = 1.0       # block density when linear_mode=sparse*

    remat: bool = True        # forward recomputes each layer in backward
    opt_state_dtype: str = "float32"  # float32 | bfloat16 (405B uses bf16)
    param_dtype: str = "bfloat16"
    seq_shard: bool = False           # SP: shard seq axis of activations

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_variant and not self.d_inner:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    @property
    def supports_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def applicable_shapes(self) -> List[ShapeSpec]:
        """The SHAPES this architecture runs: no decode for an encoder, the
        500k context for the subquadratic families only."""
        return [s for s in SHAPES.values()
                if not (s.kind == "decode" and not self.supports_decode)
                and not (s.name == "long_500k" and not self.subquadratic)]

    def param_count(self) -> int:
        """Analytic dense parameter count (for 6ND and memory napkin math)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H * Dh) + 2 * D * (Hkv * Dh) + (H * Dh) * D
        mlp = (3 if self.act == "swiglu" else 2) * D * F
        per_layer = 0
        if self.family in ("dense", "encoder", "vlm"):
            per_layer = attn + mlp
        elif self.family == "moe":
            e_mlp = 3 * D * self.d_expert
            per_layer = attn + (self.n_experts + self.n_shared_experts) \
                * e_mlp + D * self.n_experts  # router
        elif self.family == "ssm":
            di = self.d_inner
            per_layer = 4 * D * di + di * D  # qkv/in + gates + out (approx)
        elif self.family == "hybrid":
            di = self.d_inner
            per_layer = 3 * D * di + di * D + self.ssm_state * di // 8
        emb = V * D * (1 if self.tie_embeddings else 2)
        # the hybrid's one shared attention block
        extra = attn if self.family == "hybrid" and self.attn_every else 0
        return L * per_layer + emb + extra

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        D, L = self.d_model, self.n_layers
        H, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H * Dh) + 2 * D * (Hkv * Dh) + (H * Dh) * D
        e_mlp = 3 * D * self.d_expert
        per_layer = attn + (self.top_k + self.n_shared_experts) * e_mlp
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb
