"""Gemma-3 1B [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, MQA.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 head_dim=256.
26 = 4 periods of 6 + tail of 2."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6_912, vocab_size=262_144,
    pattern=("l", "l", "l", "l", "l", "g"), window=512,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    sandwich_norm=True, qk_norm=True, act="gelu",
)
