"""Gemma-3 27B [hf:google/gemma-3-*-pt; unverified] — 5:1 local:global,
128k context, window 1024, dual rope bases (local 10k / global 1M).

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144 head_dim=128.
62 = 10 full periods of 6 + tail of 2 (l, l)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21_504, vocab_size=262_144,
    pattern=("l", "l", "l", "l", "l", "g"), window=1024,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    sandwich_norm=True, qk_norm=True, act="gelu",
)
