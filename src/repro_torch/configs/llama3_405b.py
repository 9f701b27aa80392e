"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope_theta=500000.0,
    # 405B: bf16 optimizer moments keep train_4k within 16 GiB/chip HBM
    opt_state_dtype="bfloat16",
)
