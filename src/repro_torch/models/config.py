"""Model configuration dataclass shared by all 10 assigned architectures.

The port of `repro.models.config`, copied: plain dataclasses.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None      # default d_model // n_heads

    # --- layer pattern: one entry per layer within a repeating period ---
    #   "g" global attention, "l" local (sliding window) attention,
    #   "r" RG-LRU recurrent block, "w" RWKV6 time-mix block
    pattern: tuple = ("g",)
    window: int = 4096               # sliding window for "l" layers
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    qk_norm: bool = False
    sandwich_norm: bool = False      # gemma2/3 pre+post block norms

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.3

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    enc_seq: int = 1500              # fixed encoder grid (audio frames)

    # --- frontend stub: None | "audio" | "vision" ---
    frontend: str | None = None

    # --- rope / misc ---
    rope_base: float = 10_000.0
    rope_base_local: float | None = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"

    # --- conv/recurrence hyper-params (hybrid/ssm) ---
    conv_width: int = 4
    lru_dim: int | None = None       # RG-LRU width (default d_model)

    # --- training defaults ---
    lr_schedule: str = "cosine"      # "wsd" for minicpm
    optimizer: str = "adamw"         # "adafactor" for 1T-scale
    param_dtype: str = "float32"     # "bfloat16" for 1T-scale
    remat: str = "none"              # none | full | save_dots

    # sub-quadratic? (drives long_500k applicability, DESIGN §5)
    @property
    def subquadratic(self) -> bool:
        return any(k in ("l", "r", "w") for k in self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(2, len(self.pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            head_dim=16,
            d_ff=128,
            vocab_size=257,
            window=16,
            enc_seq=24,
            conv_width=4,
            lru_dim=64,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=2)
        if self.is_encdec:
            kw.update(encoder_layers=2)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
