"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VLM: VQ image
tokens share the text vocab (65536), so the backbone is a dense decoder with
qk-norm; the VQ-GAN tokenizer frontend is a STUB (input_specs provides token
ids / precomputed patch embeddings).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Pure full attention
→ long_500k skipped."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22_016, vocab_size=65_536,
    pattern=("g",), qk_norm=True, frontend="vision",
)
