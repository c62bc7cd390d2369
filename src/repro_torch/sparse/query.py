"""Two-level batched queries against a sparse suffix array.

The port of `repro.sparse.query`. An occurrence starting at text position
q is anchored at the unique sampled position ``p = q + a`` with alignment
``a = (−q) mod s``: whenever the pattern length m is ≥ s, ``a < s ≤ m``
keeps p inside the occurrence. So every occurrence is counted by exactly
one of the s alignments:

1. **Suffix search (device).** `_sparse_ranges_kernel`, the vectorised
   double binary search of `repro_torch.api.query._ranges_kernel` lifted
   from [B, 2] bound states to [B, s, 2]: alignment a of pattern b
   searches the sparse SA for the block of sampled suffixes that start
   with ``pat[a:]``. Every step gathers one [B, s, 2, L] window of text
   (int32) and does one masked 3-way prefix compare; the batch is split
   over B so no intermediate exceeds `_MAX_WINDOW` elements.
2. **Head verification (host).** `verify_alignments` confirms, for each
   candidate sampled position p, the ≤ s−1 characters before the anchor:
   ``text[p−a : p] == pat[:a]`` (and p ≥ a), with one numpy gather and
   compare per alignment over all candidates of the batch, on the index's
   cached host copy of the text. Verified candidates yield occurrence
   positions q = p − a.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.query import batch_buffers, note_shape

#: most elements of one [B, s, 2, L] window a search step materialises.
_MAX_WINDOW = 1 << 25


def _sparse_ranges_kernel(text: torch.Tensor, ssa: torch.Tensor,
                          pats: torch.Tensor, lens: torch.Tensor,
                          sample_rate: int):
    """All patterns × all s alignments × both bounds, in one search loop.

    text int32[n], ssa int64[ns] (text positions), pats int32[B, L], lens
    int32[B], all on one device. For pattern row b and alignment a the key
    is ``pats[b, a:lens[b]]`` and bounds live in [0, ns]: bound 0
    converges to the first sampled suffix ≥ the key, bound 1 to the first
    > it, so `[lo, hi)` is the candidate block per (pattern, alignment).
    Rows of length 0 resolve to (0, ns). The step count is
    ceil(log2(ns + 1)) + 1. Returns (lo, hi), each int64[B, s]."""
    n = text.shape[0]
    ns = ssa.shape[0]
    s = sample_rate
    B, L = pats.shape
    device = text.device
    steps = max(int(ns).bit_length(), 1) + 1
    col = torch.arange(L, device=device)
    # alignment-shifted pattern view: sh_pats[b, a, l] = pats[b, a + l];
    # columns past the row's length are masked by `valid`
    aidx = torch.arange(s, device=device)[:, None] + col[None, :]   # [s, L]
    sh_pats = pats[:, aidx.clamp(max=L - 1)]                        # [B, s, L]
    valid = aidx[None, :, :] < lens[:, None, None]                  # [B, s, L]
    pat = sh_pats[:, :, None, :].expand(B, s, 2, L)
    valid = valid[:, :, None, :]
    lo = torch.zeros((B, s, 2), dtype=torch.int64, device=device)
    hi = torch.full((B, s, 2), ns, dtype=torch.int64, device=device)
    for _ in range(steps):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        start = ssa[torch.where(active, mid, 0)]                # [B, s, 2]
        idx = start[..., None] + col                            # [B, s, 2, L]
        chars = torch.where(idx < n, text[idx.clamp(max=n - 1)], -1)
        diff = (chars != pat) & valid
        any_diff = diff.any(dim=-1)
        first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)
        s_at = chars.gather(-1, first)[..., 0]
        p_at = pat.gather(-1, first)[..., 0]
        less = any_diff & (s_at < p_at)          # suffix < shifted pattern
        greater = any_diff & (s_at > p_at)       # suffix > shifted pattern
        # bound 0 moves right while suffix < key; bound 1 while suffix ≤ key
        before = torch.stack([less[..., 0], ~greater[..., 1]], dim=-1)
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo[..., 0], lo[..., 1]


def sparse_ranges(index, batch, *, staged=None):
    """Level 1 for a whole `QueryBatch`: per-alignment candidate ranges.

    Returns ``(lo, hi)`` int64[n_queries, s] numpy arrays, padding rows
    sliced off. An empty index maps everything to empty ranges. Pass
    ``staged`` (`repro_torch.api.query.stage_batch`) to run against
    buffers whose copy was already started."""
    batch.check_bound_to(index)
    k, s = batch.n_queries, index.sample_rate
    if index.ns == 0 or k == 0:
        z = np.zeros((k, s), np.int64)
        return z, z.copy()
    text_d, sa_d = index._device_state()
    note_shape("sparse", batch)
    pats_d, lens_d = batch_buffers(index, batch, staged)
    B, L = pats_d.shape
    chunk = max(1, min(B, _MAX_WINDOW // (s * 2 * L)))
    parts = [_sparse_ranges_kernel(text_d, sa_d, pats_d[i:i + chunk],
                                   lens_d[i:i + chunk], s)
             for i in range(0, min(B, k), chunk)]
    both = torch.stack([torch.cat([p[0] for p in parts]),
                        torch.cat([p[1] for p in parts])]).cpu().numpy()
    return both[0, :k], both[1, :k]


def verify_alignments(index, batch, lo, hi, *, want_positions: bool = False):
    """Level 2: confirm candidate heads against the raw text.

    ``(lo, hi)`` are `sparse_ranges` outputs. For alignment a, candidate
    sampled position p matches iff ``p ≥ a`` and ``text[p−a:p] ==
    pat[:a]``; its occurrence starts at ``q = p − a``. Returns ``(counts
    int64[k], positions)`` where positions is a list of sorted int64
    arrays (one per pattern) when ``want_positions``, else None. Runs on
    the index's cached host arrays (`_host_arrays`)."""
    k = batch.n_queries
    s = index.sample_rate
    counts = np.zeros(k, np.int64)
    text, ssa = index._host_arrays()
    ssa = ssa.astype(np.int64)
    pats = batch.pats
    rows_acc: list = []
    pos_acc: list = []
    for a in range(s):
        sizes = hi[:, a] - lo[:, a]
        total = int(sizes.sum())
        if total == 0:
            continue
        rows = np.repeat(np.arange(k, dtype=np.int64), sizes)
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(sizes) - sizes, sizes))
        p = ssa[np.repeat(lo[:, a], sizes) + within]
        ok = p >= a
        if a:
            head_idx = (p[:, None] - a
                        + np.arange(a, dtype=np.int64)[None, :])
            head = text[np.clip(head_idx, 0, None)]   # clip: rows with p < a
            ok &= (head == pats[rows, :a].astype(np.int64)).all(axis=1)
        counts += np.bincount(rows[ok], minlength=k)
        if want_positions:
            rows_acc.append(rows[ok])
            pos_acc.append(p[ok] - a)
    if not want_positions:
        return counts, None
    if not rows_acc:
        return counts, [np.zeros(0, np.int64) for _ in range(k)]
    rows_cat = np.concatenate(rows_acc)
    q_cat = np.concatenate(pos_acc)
    order = np.lexsort((q_cat, rows_cat))
    rows_cat, q_cat = rows_cat[order], q_cat[order]
    splits = np.searchsorted(rows_cat, np.arange(1, k))
    return counts, np.split(q_cat, splits)
