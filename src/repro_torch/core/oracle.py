"""Naive suffix-array oracles used to validate every other implementation."""
from __future__ import annotations

import numpy as np


def suffix_array_naive(x) -> np.ndarray:
    """O(n² log n) reference: sort suffixes directly. Test-sized inputs only."""
    x = np.asarray(x, dtype=np.int64)
    n = len(x)
    suffixes = [tuple(x[i:]) for i in range(n)]
    order = sorted(range(n), key=lambda i: suffixes[i])
    return np.asarray(order, dtype=np.int64)


def suffix_array_doubling(x) -> np.ndarray:
    """O(n log² n) prefix-doubling oracle (numpy), for larger benchmark inputs.

    Classic Manber–Myers by repeated lexsort on (rank[i], rank[i+h]).
    """
    x = np.asarray(x, dtype=np.int64)
    n = len(x)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # initial ranks from single characters
    rank = np.unique(x, return_inverse=True)[1].astype(np.int64)
    h = 1
    idx = np.arange(n)
    while True:
        key2 = np.where(idx + h < n, np.concatenate([rank[h:], np.full(min(h, n), -1)])[:n], -1)
        order = np.lexsort((key2, rank))
        # recompute dense ranks
        r_o, k_o = rank[order], key2[order]
        new_rank = np.zeros(n, dtype=np.int64)
        boundary = np.ones(n, dtype=bool)
        boundary[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        new_rank[order] = np.cumsum(boundary) - 1
        rank = new_rank
        if rank.max() == n - 1:
            return order.astype(np.int64)
        h *= 2
        if h >= 2 * n:  # pragma: no cover - safety
            return order.astype(np.int64)


def rank_of_suffixes(sa: np.ndarray) -> np.ndarray:
    """Inverse permutation: rank[i] = position of suffix i in the SA."""
    sa = np.asarray(sa)
    inv = np.empty_like(sa)
    inv[sa] = np.arange(len(sa))
    return inv
