"""LCP array (Kasai's algorithm) — the bridge from the paper's suffix arrays
to the LM data pipeline (exact-substring dedup, n-gram stats)."""
from __future__ import annotations

import numpy as np


def lcp_kasai(x, sa) -> np.ndarray:
    """LCP[i] = longest common prefix of suffixes sa[i-1], sa[i]; LCP[0]=0.

    O(n) (Kasai et al. 2001)."""
    x = np.asarray(x)
    sa = np.asarray(sa)
    n = len(x)
    lcp = np.zeros(n, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n and j + h < n and x[i + h] == x[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def repeated_substring_spans(x, sa, lcp, min_len: int):
    """All positions covered by a substring of length ≥ min_len that occurs
    at least twice (the Lee et al. 2022 dedup criterion). Returns a sorted
    list of (start, end) half-open spans, merged."""
    n = len(sa)
    spans = []
    for r in range(1, n):
        l = int(lcp[r])
        if l >= min_len:
            for start in (int(sa[r]), int(sa[r - 1])):
                spans.append((start, start + l))
    if not spans:
        return []
    spans.sort()
    merged = [spans[0]]
    for s, e in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def ngram_counts(x, sa, lcp, k: int):
    """Number of distinct k-grams (via SA+LCP: Σ max(0, run starts))."""
    n = len(sa)
    distinct = 0
    for r in range(n):
        if int(sa[r]) + k <= n and int(lcp[r]) < k:
            distinct += 1
    return distinct
