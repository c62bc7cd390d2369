"""Plain PyTorch versions of the kernels in `repro_torch.kernels`.

One per kernel, with the contracts of `repro.kernels.ref`. They run on any
device: the CPU path of every wrapper in `repro_torch.kernels.ops` runs
them, and on the card they are what each kernel is held against.
"""
from __future__ import annotations

import torch


def _lex_lt(a: torch.Tensor, b: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Row-wise strict lexicographic a < b over the first num_keys columns."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for c in range(num_keys):
        lt |= eq & (a[..., c] < b[..., c])
        eq &= a[..., c] == b[..., c]
    return lt


def bitonic_stage_ref(rows: torch.Tensor, k: int, j: int,
                      num_keys: int | None = None) -> torch.Tensor:
    """One bitonic compare-exchange stage (k, j) over rows [N, W]: row i
    pairs with row i^j, ascending iff (i & k) == 0, and keeps its own value
    iff (lt(self, partner) == self_is_lower) == ascending."""
    n, w = rows.shape
    num_keys = num_keys or w
    idx = torch.arange(n, device=rows.device)
    partner = idx ^ j
    other = rows[partner]
    up = (idx & k) == 0
    lower = idx < partner
    keep = (_lex_lt(rows, other, num_keys) == lower) == up
    return torch.where(keep[:, None], rows, other)


def bitonic_sort_ref(rows: torch.Tensor,
                     num_keys: int | None = None) -> torch.Tensor:
    """Oracle: rows stably sorted by their first num_keys columns (stable
    passes from the last key to the first, as `numpy.lexsort` orders)."""
    num_keys = num_keys or rows.shape[1]
    order = torch.arange(rows.shape[0], device=rows.device)
    for c in reversed(range(num_keys)):
        order = order[torch.sort(rows[order, c], stable=True).indices]
    return rows[order]


def seg_boundary_ref(rows: torch.Tensor, num_keys: int | None = None,
                     block: int = 512):
    """Sorted rows [N, W], N a multiple of block -> (flags int32[N],
    csum int32[N], totals int32[N // block]): flag[i] marks row i differing
    from row i-1 on the first num_keys columns, with the first row of every
    block forced to 1; csum is the block-inclusive prefix sum of the flags,
    totals the per-block flag count."""
    n, w = rows.shape
    num_keys = num_keys or w
    keys = rows[:, :num_keys]
    prev = torch.cat([keys[:1], keys[:-1]], dim=0)
    neq = (keys != prev).any(dim=1).reshape(n // block, block)
    neq[:, 0] = True
    flags = neq.reshape(-1).to(torch.int32)
    csum = torch.cumsum(neq, dim=1, dtype=torch.int32).reshape(-1)
    totals = neq.sum(dim=1, dtype=torch.int32)
    return flags, csum, totals
