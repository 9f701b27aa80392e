"""olmoe-1b-7b [moe] — 64 routed experts, top-8, no shared experts
[arXiv:2409.02060]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    act="swiglu",
    norm="rms",
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    d_expert=1024,
)
