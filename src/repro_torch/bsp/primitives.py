"""Vectorised primitives on fixed-shape integer tensors with validity
masks: the port of `repro.bsp.primitives`.

Everything here runs inside one rank's body on fixed-shape int32 tensors
(BSP processors hold equal-size blocks; ragged reality is expressed with
masks, never with shapes that depend on the data).
"""
from __future__ import annotations

import math

import torch

from ..core.words import run_starts
from ..trace import span

INT32_MAX = torch.iinfo(torch.int32).max


def compact_valid(rows: torch.Tensor, valid: torch.Tensor):
    """Stable-move valid rows to the front. rows [m, W], valid bool[m].
    Returns (rows, valid, order), as a stable argsort of ``~valid`` would:
    the order comes from two running counts, with no sort."""
    m = valid.shape[0]
    n_valid = valid.sum()
    dest = torch.where(valid, torch.cumsum(valid, 0) - 1,
                       n_valid + torch.cumsum(~valid, 0) - 1)
    order = torch.empty_like(dest).scatter_(
        0, dest, torch.arange(m, device=valid.device))
    return rows[order], valid[order], order


def within_group_index(group: torch.Tensor, valid: torch.Tensor):
    """For each element, its index among *valid* elements with the same
    `group` value (order = original position). Invalid elements get 0.

    A stable sort of the group ids (invalid ones last), each slot's run
    start from the boundary flags (`core.words.run_starts`: one cumsum,
    one scatter, one gather, no scan in series), and the positions
    scattered back. Returns int32[m]."""
    with span("repro_torch.bsp.group_index"):
        m = group.shape[0]
        big = torch.where(valid, group.to(torch.int32), INT32_MAX)
        order = torch.sort(big, stable=True).indices      # valid groups first
        g_sorted = big[order]
        pos = torch.arange(m, dtype=torch.int64, device=group.device)
        boundary = torch.ones(m, dtype=torch.bool, device=group.device)
        if m > 1:
            boundary[1:] = g_sorted[1:] != g_sorted[:-1]
        run_start = run_starts(boundary)
        out = torch.empty_like(pos).scatter_(0, order, pos - run_start)
        return torch.where(valid, out, 0).to(torch.int32)


def counts_per_bucket(dest: torch.Tensor, valid: torch.Tensor, p: int):
    """Histogram of dest (∈[0,p)) over valid rows → int32[p] (one-hot sum,
    as the reference computes it)."""
    oh = (dest[:, None] == torch.arange(p, dtype=dest.dtype,
                                        device=dest.device)[None, :])
    return (oh & valid[:, None]).sum(0, dtype=torch.int32)


def lex_lt_rows(a: torch.Tensor, b: torch.Tensor):
    """Row-wise lexicographic a < b for int rows [N, W]; ties → False."""
    neq = a != b
    first = neq.to(torch.uint8).argmax(dim=-1, keepdim=True)
    a_star = a.gather(-1, first)[:, 0]
    b_star = b.gather(-1, first)[:, 0]
    return neq.any(dim=-1) & (a_star < b_star)


def searchsorted_rows(splitters: torch.Tensor, rows: torch.Tensor,
                      lt_fn=None):
    """dest[i] = #{s : splitter_s < row_i} for row-valued splitters.

    splitters [q, W] must be sorted by the same order. Vectorised binary
    search, ⌈log2 q⌉ + 1 iterations. `lt_fn(a_rows, b_rows)` defaults to
    lexicographic on int columns. Returns int32[m] in [0, q].
    """
    if lt_fn is None:
        lt_fn = lex_lt_rows
    q = splitters.shape[0]
    m = rows.shape[0]
    lo = torch.zeros(m, dtype=torch.int32, device=rows.device)
    hi = torch.full((m,), q, dtype=torch.int32, device=rows.device)
    steps = max(1, int(math.ceil(math.log2(max(q, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        s = splitters[mid.clamp(0, q - 1).long()]
        # splitter[mid] < row  → answer is right of mid
        go_right = lt_fn(s, rows) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.maximum(mid, lo))
    return lo


def local_sort_rows(rows: torch.Tensor, valid: torch.Tensor, num_keys: int):
    """Sort rows (int32[m, W]) lexicographically by their first num_keys
    columns, invalid rows last, ties in row order (stable `torch.sort`
    passes, last key first). Returns (rows_sorted, valid_sorted)."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for key in [rows[:, c] for c in reversed(range(num_keys))] + [
            (~valid).to(torch.uint8)]:
        order = order[torch.sort(key[order], stable=True).indices]
    return rows[order], valid[order]


__all__ = ["INT32_MAX", "compact_valid", "counts_per_bucket", "lex_lt_rows",
           "local_sort_rows", "searchsorted_rows", "within_group_index"]
