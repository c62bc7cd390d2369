"""Vectorised primitives on fixed-shape integer tensors with validity
masks: the port of `repro.bsp.primitives`.

Only `within_group_index` is ported; the other primitives of the JAX
package's module (`compact_valid`, `counts_per_bucket`, `lex_lt_rows`,
`searchsorted_rows`) come with the rest of `bsp` (ROADMAP queue 1,
item 3).
"""
from __future__ import annotations

import torch

INT32_MAX = torch.iinfo(torch.int32).max


def within_group_index(group: torch.Tensor, valid: torch.Tensor):
    """For each element, its index among *valid* elements with the same
    `group` value (order = original position). Invalid elements get 0.

    A stable sort of the group ids (invalid ones last), run starts from
    the boundary flags, their running maximum (`torch.cummax`), and the
    positions scattered back. Returns int32[m]."""
    m = group.shape[0]
    big = torch.where(valid, group.to(torch.int32), INT32_MAX)
    order = torch.sort(big, stable=True).indices          # valid groups first
    g_sorted = big[order]
    pos = torch.arange(m, dtype=torch.int64, device=group.device)
    boundary = torch.ones(m, dtype=torch.bool, device=group.device)
    if m > 1:
        boundary[1:] = g_sorted[1:] != g_sorted[:-1]
    run_start = torch.cummax(torch.where(boundary, pos, 0), dim=0).values
    out = torch.empty_like(pos).scatter_(0, order, pos - run_start)
    return torch.where(valid, out, 0).to(torch.int32)


__all__ = ["INT32_MAX", "within_group_index"]
