"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct; hf] —
16 experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064. Pure full attention
→ long_500k skipped."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6_400, vocab_size=32_064,
    pattern=("g",), n_experts=16, top_k=2,
)
