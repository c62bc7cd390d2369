"""Whisper-small [arXiv:2212.04356; unverified] — encoder-decoder; the conv
mel frontend is a STUB (input_specs provides precomputed frame embeddings,
enc_seq=1500). Decoder self-attn is causal full attention + cross-attention
to the encoder. long_500k skipped (30 s audio; full attention).

12L(dec) + 12L(enc) d_model=768 12H (kv=12) d_ff=3072 vocab=51865."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3_072, vocab_size=51_865,
    pattern=("g",), encoder_layers=12, enc_seq=1500,
    rope_base=0.0, frontend="audio", act="gelu",
)
