"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table] — trillion-
parameter MoE: 384 experts, top-8, fine-grained d_ff=2048 per expert.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840. Pure full attention
→ long_500k skipped. bf16 params + Adafactor (1T-scale memory, DESIGN §6)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2_048, vocab_size=163_840,
    pattern=("g",), n_experts=384, top_k=8,
    param_dtype="bfloat16", optimizer="adafactor", remat="full",
)
