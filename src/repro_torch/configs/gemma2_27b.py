"""Gemma-2 27B [arXiv:2408.00118; hf] — 1:1 local:global alternation,
logit softcap 30 / attention softcap 50, sandwich norms, window 4096.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 head_dim=128.
Hybrid local/global → long_500k runs (local layers bound KV; global layers
decode-linear)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36_864, vocab_size=256_000,
    pattern=("l", "g"), window=4096,
    logit_softcap=30.0, attn_softcap=50.0, sandwich_norm=True,
    act="gelu",
)
