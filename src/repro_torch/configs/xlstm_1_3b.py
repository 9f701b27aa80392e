"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (48 = 6 super-blocks of
[1 sLSTM + 7 mLSTM]) [arXiv:2405.04517].

Sub-quadratic (chunkwise-parallel linear recurrence) — runs long_500k."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    ssm_variant="mlstm",
    slstm_every=8,
    d_inner=4096,
)
