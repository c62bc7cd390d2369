"""The plain reference of a sampled index: the sparse suffix array as
documented, the dense suffix array restricted to the sampled positions.

`sparse_suffix_array(text, s)` is `sabench.reference.suffix_array` (prefix
doubling in stock PyTorch operations) with only the positions that are
multiples of `s` kept, in the dense order. It shares nothing with the
program under test.
"""
from __future__ import annotations

import torch

from sabench import reference


def sparse_suffix_array(text: torch.Tensor, s: int) -> torch.Tensor:
    """Text positions 0, s, 2s, ... sorted by their whole suffixes (int64
    on `text`'s device)."""
    s = int(s)
    if s < 1:
        raise ValueError(f"sample rate must be at least 1, got {s}")
    sa = reference.suffix_array(text)
    return sa[sa % s == 0]
