"""Bulk-synchronous building blocks: the port of `repro.bsp`.

Only `within_group_index` is here so far, the primitive the MoE router
needs (`repro_torch.models.ffn`). The rest of the JAX package's
`repro.bsp` (the other primitives, the exchange, the parallel sort and
Algorithm 2/3) is ROADMAP queue 1, item 3.
"""
from .primitives import within_group_index

__all__ = ["within_group_index"]
