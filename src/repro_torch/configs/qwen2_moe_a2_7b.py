"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    act="swiglu",
    norm="rms",
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_expert=1408,
    rope_theta=1000000.0,
)
