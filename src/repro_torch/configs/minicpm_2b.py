"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule.

40L d_model=2304 36H (GQA kv=36 == MHA) d_ff=5760 vocab=122753.
Pure full attention → long_500k cell skipped (DESIGN §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122_753,
    pattern=("g",), rope_base=10_000.0,
    lr_schedule="wsd",
)
