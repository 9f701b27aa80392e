"""hubert-xlarge [audio] — encoder-only transformer backbone
(frame embeddings provided by the stub frontend) [arXiv:2106.07447].

Encoder-only: no decode step exists, so ``applicable_shapes`` skips
decode_32k and long_500k."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    act="gelu",
    norm="ln",
    causal=False,
    frontend="frame",
)
