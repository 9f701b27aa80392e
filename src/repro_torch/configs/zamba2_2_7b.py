"""zamba2-2.7b [hybrid] — Mamba2 backbone + tied shared attention block
every 6 layers (54 = 9 super-blocks) [arXiv:2411.15242].

Sub-quadratic — runs long_500k."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_variant="mamba2",
    ssm_state=64,
    attn_every=6,
    d_inner=5120,
)
