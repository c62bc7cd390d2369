"""Comparator-based bitonic sort in PyTorch.

The Lemma-1 comparison of the paper's Step 4, `rank[i + Λ[k_i][k_j]]`,
is pairwise: it has no per-element key that a key-based sort could use.
A bitonic network with a branchless compare-exchange evaluates such a
comparator for every pair of a stage at once: O(log² N) stages, each a
gather and a select over the whole payload.

The comparator must be a *strict total order* (break ties by a unique
index column) so both elements of a pair agree on the exchange direction.
"""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (1 for n ≤ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def stage_schedule(n_pow2: int) -> list[tuple[int, int]]:
    """All (k, j) bitonic stages for size n_pow2, in execution order."""
    stages = []
    k = 2
    while k <= n_pow2:
        j = k // 2
        while j >= 1:
            stages.append((k, j))
            j //= 2
        k *= 2
    return stages


def bitonic_sort(payload: dict, lt_fn) -> dict:
    """Sort `payload` (dict of tensors sharing leading dim N, a power of
    two) ascending by the strict total order `lt_fn(a, b) -> bool[N]`.

    `lt_fn` receives two payload dicts (self, partner) and returns
    element-wise "self strictly precedes partner".
    """
    first = next(iter(payload.values()))
    n = first.shape[0]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort needs a power-of-two length, got {n}")
    idx = torch.arange(n, device=first.device)
    for k, j in stage_schedule(n):
        partner = idx ^ j
        other = {name: t[partner] for name, t in payload.items()}
        # pair (low, high): low ends up with the min iff ascending. An
        # element keeps its own value iff (lt(self, partner) == lower) == up.
        keep = (lt_fn(payload, other) == (idx < partner)) == ((idx & k) == 0)
        payload = {
            name: torch.where(keep.view((-1,) + (1,) * (t.dim() - 1)), t,
                              other[name])
            for name, t in payload.items()}
    return payload


def lex_lt_int(a_cols: torch.Tensor, b_cols: torch.Tensor):
    """Vectorised lexicographic (lt, all_eq) over the trailing axis of
    int columns [N, W], without a loop over W: the first differing column
    is the argmax of the inequality mask."""
    neq = a_cols != b_cols
    any_neq = neq.any(dim=-1)
    first = neq.to(torch.uint8).argmax(dim=-1, keepdim=True)
    lt = any_neq & (a_cols.gather(-1, first)[:, 0]
                    < b_cols.gather(-1, first)[:, 0])
    return lt, ~any_neq


def sort_rows_with_index(cols: torch.Tensor, num_cols: int) -> torch.Tensor:
    """Key-based row sort: the permutation (int64[N]) that sorts the rows
    of `cols` lexicographically by their first `num_cols` columns, ties in
    row order. Stable `torch.sort` passes, last column first."""
    order = torch.arange(cols.shape[0], device=cols.device)
    for c in reversed(range(num_cols)):
        order = order[torch.sort(cols[order, c], stable=True).indices]
    return order
