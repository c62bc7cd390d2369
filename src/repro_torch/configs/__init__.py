"""Launch configurations: ``--arch <id>`` resolves here.

The port of `repro.configs`: the paper's own workload, ``suffix-array``
(`SAConfig`), and the ten model architectures of the JAX package.
"""
from __future__ import annotations

from importlib import import_module

from .suffix_array import CONFIG as SUFFIX_ARRAY, SAConfig

#: the JAX package's model architectures (ids and their CLI spellings).
MODEL_ARCHS = (
    "minicpm_2b", "gemma2_27b", "gemma3_27b", "gemma3_1b",
    "recurrentgemma_2b", "kimi_k2_1t_a32b", "phi35_moe_42b_a6_6b",
    "rwkv6_1_6b", "chameleon_34b", "whisper_small",
)

#: the model architectures the port runs: all of them.
PORTED_ARCHS = MODEL_ARCHS

_ALIASES = {
    "minicpm-2b": "minicpm_2b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-27b": "gemma3_27b",
    "gemma3-1b": "gemma3_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "chameleon-34b": "chameleon_34b",
    "whisper-small": "whisper_small",
}


def get_config(arch: str):
    """The configuration of ``--arch arch``: `SAConfig` for
    ``suffix-array``, a `ModelConfig` for a model architecture; an
    unknown one raises `ValueError`."""
    key = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if key == "suffix_array":
        return SUFFIX_ARRAY
    if key in MODEL_ARCHS:
        return import_module(f"{__name__}.{key}").CONFIG
    raise ValueError(f"unknown --arch {arch!r}; expected suffix-array or "
                     f"one of {sorted(_ALIASES)}")


def model_archs() -> list[str]:
    return list(MODEL_ARCHS)


__all__ = ["MODEL_ARCHS", "PORTED_ARCHS", "SAConfig", "get_config",
           "model_archs"]
