"""llama3.2-1b [dense] — small llama3, tied embeddings
[hf:meta-llama/Llama-3.2-1B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    act="swiglu",
    norm="rms",
    rope_theta=500000.0,
    tie_embeddings=True,
)
