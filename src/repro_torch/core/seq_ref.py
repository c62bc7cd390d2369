"""Paper-faithful sequential DC-v suffix array construction (Algorithm 1).

This is the *executable specification* of Pace & Tiskin 2013, Section 3 — the
steps are kept literal (Step 0 sample construction, Step 1 recursive sample
sort, Step 2 per-class non-sample sort, Step 3 v-character sort, Step 4
Lemma-1 v-way merge). numpy is used for the radix/counting sorts (lexsort is
key-based, i.e. radix semantics); clarity is preferred over speed — the
optimised path lives in `dcv_torch.py`.

Canonical padding
-----------------
The paper's block/terminator structure (§3 Step 1: "the last super-character of
X_k ends with one or more -1 elements") is guaranteed only when n ≡ 0 (mod v)
and 0 ∉ D. We therefore pad the index domain to n_v = v·ceil(n/v) with
sentinel (-1) characters and treat pad positions as genuine suffixes. Pad
suffixes start with -1 < every real character, so they never disturb the
relative order of real suffixes, and they are dropped from the returned SA.
This matches the classic DC3 "append zeros / include the empty suffix" trick,
generalised to arbitrary v.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .difference_cover import cover_tables
from .oracle import suffix_array_doubling


@dataclass
class SeqStats:
    """Instrumentation: one entry per recursion round (EXPERIMENTS C3)."""

    rounds: list = field(default_factory=list)  # dicts: v, |D|, n, work

    def add(self, *, v: int, dsize: int, n: int, work: int) -> None:
        self.rounds.append({"v": v, "D": dsize, "n": n, "work": work})


def accelerated_next_v(v: int, dsize: int, m: int) -> int:
    """v' = min(v^{5/4}, v²/|D| − 1, m), clamped to ≥ 3 (paper §5, Step 1)."""
    if m < 3:
        return 3
    # paper §1.1: real numbers are *rounded up*; bound v' < v²/|D| keeps the
    # total work linear (§3 Step 1).
    cap_work = max(3, int(np.ceil(v * v / max(dsize, 1))) - 1)
    accel = max(3, int(np.ceil(float(v) ** 1.25)))
    return int(min(accel, cap_work, m))


def fixed_next_v(v: int, dsize: int, m: int) -> int:
    """Non-accelerated baseline: constant v (the Kärkkäinen et al. regime)."""
    return int(min(v, max(m, 3)))


def _pad_to_multiple(x: np.ndarray, v: int) -> np.ndarray:
    n = len(x)
    n_v = v * int(np.ceil(n / v)) if n else v
    out = np.full(n_v + 2 * v, -1, dtype=np.int64)  # +2v char lookahead buffer
    out[:n] = x
    return out


def _windows(xp: np.ndarray, positions: np.ndarray, v: int) -> np.ndarray:
    """Windows x[i:i+v) for each i in positions → int64[len(positions), v]."""
    return xp[positions[:, None] + np.arange(v)[None, :]]


def _lexsort_rows(rows: np.ndarray, tiebreak: np.ndarray | None = None):
    """Sort rows lexicographically (radix over columns); returns order."""
    keys = [rows[:, c] for c in range(rows.shape[1] - 1, -1, -1)]
    if tiebreak is not None:
        keys = [tiebreak] + keys
    return np.lexsort(keys)


def _dense_ranks(sorted_rows: np.ndarray) -> tuple[np.ndarray, bool]:
    """Dense ranks of sorted rows + all-distinct flag."""
    m = len(sorted_rows)
    boundary = np.ones(m, dtype=bool)
    if m > 1:
        boundary[1:] = np.any(sorted_rows[1:] != sorted_rows[:-1], axis=1)
    ranks = np.cumsum(boundary) - 1
    return ranks, bool(boundary.all())


def suffix_array_dcv(
    x,
    v: int = 3,
    schedule=accelerated_next_v,
    base_threshold: int = 32,
    stats: SeqStats | None = None,
    _depth: int = 0,
) -> np.ndarray:
    """Suffix array of x (ints ≥ 0) by the paper's DC-v algorithm.

    Parameters mirror Algorithm 1: `v` is the difference-cover modulus for
    this round; `schedule(v, |D|, m)` picks v' for the recursive call
    (accelerated_next_v reproduces the paper's v^{5/4} regime; fixed_next_v is
    the constant-v baseline).
    """
    x = np.asarray(x, dtype=np.int64)
    n = len(x)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n <= max(base_threshold, v):  # paper: sequential base once tiny
        if stats is not None:
            stats.add(v=v, dsize=0, n=n, work=n)
        return suffix_array_doubling(x)

    # ---- Recursion base check: all characters distinct → SA = argsort ----
    order0 = np.argsort(x, kind="stable")
    if len(np.unique(x)) == n:
        if stats is not None:
            stats.add(v=v, dsize=0, n=n, work=n)
        return order0.astype(np.int64)

    v = int(min(max(v, 3), n))
    tabs = cover_tables(v)
    D = np.asarray(tabs.D, dtype=np.int64)
    dsize = len(D)
    if stats is not None:
        stats.add(v=v, dsize=dsize, n=n, work=v * n)

    # ---- Step 0: sample construction ----
    xp = _pad_to_multiple(x, v)
    n_v = len(xp) - 2 * v
    per_block = n_v // v
    # B_k = {i : i mod v = k}; C = ∪_{k∈D} B_k  (block-major order as in X)
    sample_pos = (D[:, None] * 0 + np.arange(per_block)[None, :] * v + D[:, None]).reshape(-1)
    m = dsize * per_block
    rank = np.full(n_v + v, -1, dtype=np.int64)

    # ---- Step 1: sort sample suffixes (recurse on super-character string) --
    W = _windows(xp, sample_pos, v)                 # super-characters
    order = _lexsort_rows(W)
    ranks_sorted, distinct = _dense_ranks(W[order])
    Xp = np.empty(m, dtype=np.int64)                # X' over Σ' = [0:m)
    Xp[order] = ranks_sorted
    if distinct:
        # all super-characters distinct → SA_{X'} is just the sort order
        sa_rank = np.empty(m, dtype=np.int64)
        sa_rank[order] = np.arange(m)
    else:
        v_next = schedule(v, dsize, m)
        sa_sub = suffix_array_dcv(
            Xp, v=v_next, schedule=schedule, base_threshold=base_threshold,
            stats=stats, _depth=_depth + 1,
        )
        sa_rank = np.empty(m, dtype=np.int64)
        sa_rank[sa_sub] = np.arange(m)
    rank[sample_pos] = sa_rank

    # ---- Step 2: order non-sample suffixes within each class S_k, k ∉ D ----
    # Within-class key: (x[i..i+l_k-1], rank[i+l_k]) with (k+l_k) mod v ∈ D.
    within_rank = np.full(n_v, -1, dtype=np.int64)  # order within S_k
    for k in range(v):
        pos_k = np.arange(k, n_v, v)
        if tabs.in_D[k]:
            # within-class order of sample classes = restriction of sa_rank
            o = np.argsort(rank[pos_k], kind="stable")
        else:
            l_k = int(tabs.shifts[k][0])            # min l ≥ 1 with (k+l)∈D
            chars = _windows(xp, pos_k, l_k) if l_k > 0 else np.zeros((len(pos_k), 0), np.int64)
            tup = np.concatenate([chars, rank[pos_k + l_k][:, None]], axis=1)
            o = _lexsort_rows(tup)
        within_rank[pos_k[o]] = np.arange(len(pos_k))

    # ---- Step 3: sort all suffixes by their first v characters ----
    all_pos = np.arange(n_v)
    Wall = _windows(xp, all_pos, v)
    order3 = _lexsort_rows(Wall, tiebreak=all_pos)
    group_ranks, _ = _dense_ranks(Wall[order3])
    group_of = np.empty(n_v, dtype=np.int64)
    group_of[order3] = group_ranks

    # ---- Step 4: v-way merge inside each group S^α via Lemma 1 ----
    lam = tabs.lam
    sa_full = np.empty(n_v, dtype=np.int64)
    out = 0
    sorted_pos = all_pos[order3]
    bounds = np.flatnonzero(np.r_[True, group_ranks[1:] != group_ranks[:-1], True])
    for gi in range(len(bounds) - 1):
        members = sorted_pos[bounds[gi]:bounds[gi + 1]]
        if len(members) == 1:
            sa_full[out] = members[0]
            out += 1
            continue
        # per-class sorted sub-lists (classes already ordered by steps 1-2)
        heads: dict[int, list] = {}
        for i in members:
            heads.setdefault(int(i % v), []).append(int(i))
        for k in heads:
            heads[k].sort(key=lambda i: within_rank[i])
        lists = [heads[k] for k in sorted(heads)]
        ptrs = [0] * len(lists)
        # comparison-based v-way merge: compare heads via rank[i+l], l = Λ
        remaining = len(members)
        while remaining:
            best = -1
            for a in range(len(lists)):
                if ptrs[a] >= len(lists[a]):
                    continue
                if best == -1:
                    best = a
                    continue
                i, j = lists[best][ptrs[best]], lists[a][ptrs[a]]
                l = lam[i % v, j % v]
                if rank[j + l] < rank[i + l]:
                    best = a
            sa_full[out] = lists[best][ptrs[best]]
            ptrs[best] += 1
            out += 1
            remaining -= 1

    sa = sa_full[sa_full < n]
    return sa.astype(np.int64)
