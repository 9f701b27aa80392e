"""starcoder2-7b [dense] — GQA kv=4, RoPE, GELU MLP + LayerNorm
[arXiv:2402.19173]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    act="gelu",
    norm="ln",
    qkv_bias=True,
    rope_theta=1000000.0,
)
