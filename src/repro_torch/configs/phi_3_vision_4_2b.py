"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub frontend
(576 patch embeddings prepended) [hf:microsoft/Phi-3-vision-128k-instruct]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    act="swiglu",
    norm="rms",
    frontend="patch",
    n_prefix_tokens=576,
)
