"""RWKV6 "Finch" 1.6B [arXiv:2404.05892; unverified] — attention-free SSM
with data-dependent decay; O(1)/token decode → long_500k runs.

24L d_model=2048 d_ff=7168 vocab=65536; WKV heads = d/64 = 32."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7_168, vocab_size=65_536,
    pattern=("w",), rope_base=0.0,
)
