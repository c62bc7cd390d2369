"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf] — RG-LRU + local
attention 2:1, window 2048.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 lru_dim=2560.
26 = 8 periods of (r, r, l) + tail of 2 (r, r)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7_680, vocab_size=256_000,
    pattern=("r", "r", "l"), window=2048, lru_dim=2560,
    act="gelu",
)
