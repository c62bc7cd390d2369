"""Vectorised single-device DC-v suffix array construction in PyTorch.

The port of `repro.core.dcv_jax`: the same mathematics as `seq_ref`
(difference-cover sampling + Lemma-1 comparisons), organised so that each
recursion level is dominated by ONE multi-key sort:

* the v-character windows of ALL n_v positions are sorted once per level;
  the sample super-character ranks of Step 1 fall out of that order by
  filtering it to sample positions (a stable subsequence of a sorted
  sequence is sorted), and the same order is the Steps 2–4 candidate;
* suffix pairs sharing their full v-prefix form *tie groups*; large tie
  sets are first shrunk by stride-doubling refinement rounds, and the
  residue is resolved with the paper's Lemma-1 comparator
  `rank[i + Λ[k_i][k_j]]` on a compacted payload: a keyed sort of each
  group's classes, then one merge launch.

Every tensor stays on the input's device. The host reads the device only
where Python control flow needs a number: whether the sample ranks are
all distinct (one read per level) and the size of the unresolved tie set
after each refinement round.

Counters (`repro_torch.trace.count`, host integers already read):
``repro_torch.dcv.levels`` (one a level that sorts windows),
``repro_torch.dcv.refine_rounds`` (one a refinement round) and
``repro_torch.dcv.lemma1_rows`` (the tied rows handed to Lemma 1).

`sort_impl` picks the window sort (see `repro_torch.core.compat`):
"kernel" sorts window rows with the bitonic kernel and ranks the samples
with `dense_rank_sorted`; "torch" packs the window columns into int64
words and sorts them with stable `torch.sort` passes; "radix" sorts the
same words with `radix_argsort`, the LSD radix sort on the histogram and
scatter kernels. "torch" and "radix" rank the samples from the words:
"torch" with stock gathers and compares (`rows_neq`), "radix" with
`dense_rank_gathered`, which also marks the window order's run starts.
"bitonic" is the JAX package's legacy fused path: a key sort ranks the
sample windows, and ONE comparator-bitonic network (`core.bitonic`, the
Lemma-1 comparator at every stage) sorts all suffixes of a level.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.ops import bitonic_sort as kernel_bitonic_sort
from ..kernels.ops import dense_rank_gathered, dense_rank_sorted
from ..kernels.ref import rows_neq
from ..trace import count, span
from .bitonic import (bitonic_sort, lex_lt_int, next_pow2,
                      sort_rows_with_index)
from .compat import resolve_device, resolve_sort_impl
from .difference_cover import cover_tables
from .seq_ref import accelerated_next_v
from .words import argsort_words, compact, lemma1_order, pack_words, run_state

INT32_MAX = 2 ** 31 - 1
I64 = torch.int64


# --------------------------------------------------------------------------
# per-level constants
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def cover_constants(v: int, device: torch.device):
    """Device copies of the (small) cover tables of modulus v:
    (D int64[|D|], in_D bool[v], shifts int64[v, |D|], lam1, lam2
    int64[v, v]). Cached so a level does not copy them again."""
    tabs = cover_tables(v)
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in (np.asarray(tabs.D, np.int64), tabs.in_D,
                           tabs.shifts.astype(np.int64),
                           tabs.lam_idx1.astype(np.int64),
                           tabs.lam_idx2.astype(np.int64)))


def level_constants(n_v: int, v: int, device: torch.device):
    """Constants of one (n_v, v) level on `device`: (sample_pos int64[m] in
    block-major order, inv_sample int64[n_v] (-1 off the sample), in_D,
    shifts, lam1, lam2). The position maps are computed on the device, so
    no level copies an n_v-sized table from the host."""
    D, in_D, shifts, lam1, lam2 = cover_constants(v, device)
    per_block = n_v // v
    sample_pos = (D[:, None] + torch.arange(per_block, device=device)[None, :]
                  * v).reshape(-1)
    inv_sample = torch.full((n_v,), -1, dtype=I64, device=device)
    inv_sample[sample_pos] = torch.arange(len(sample_pos), device=device)
    return sample_pos, inv_sample, in_D, shifts, lam1, lam2


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def padded_text(x: torch.Tensor, n_v: int, v: int) -> torch.Tensor:
    """x padded to n_v + 2v with *distinct, decreasing* negative sentinels.

    Distinct sentinels keep the pad suffixes out of each other's tie
    groups. Correctness needs only "below the alphabet": the first
    differing window column between two real suffixes is never pad-vs-pad
    (pad values are position-unique)."""
    n = len(x)
    xp = torch.empty(n_v + 2 * v, dtype=I64, device=x.device)
    xp[:n] = x
    xp[n:] = -1 - torch.arange(n_v + 2 * v - n, device=x.device)
    return xp


def window_rows(xp: torch.Tensor, n_v: int, v: int) -> torch.Tensor:
    """int32[next_pow2(n_v), v + 1]: the v-character window of every
    position plus an index column (a total order), then INT32_MAX pad rows,
    which sort after every real row."""
    n2 = next_pow2(n_v)
    rows = torch.empty((n2, v + 1), dtype=torch.int32, device=xp.device)
    for c in range(v):
        rows[:n_v, c] = xp[c:c + n_v]
    rows[:n_v, v] = torch.arange(n_v, dtype=torch.int32, device=xp.device)
    rows[n_v:] = INT32_MAX
    return rows


def window_words(xp: torch.Tensor, n_v: int, v: int, lo: int,
                 hi: int) -> tuple[list[torch.Tensor], list[int]]:
    """The v-character windows at positions [0, n_v), values in [lo, hi],
    shifted to non-negative and packed by `core.words.pack_words` (v
    columns of one width): (words, their bit widths)."""
    bits = max(1, int(hi - lo).bit_length())
    return pack_words((xp[c:c + n_v] - lo for c in range(v)), [bits] * v)


def window_order(xp: torch.Tensor, n_v: int, v: int, lo: int, hi: int,
                 impl: str):
    """Sort all n_v window rows with the chosen impl.

    Returns (order int64[n_v], is_start bool[n_v], sorted_rows): `order`
    sorts positions by (window, position); `is_start` marks the
    row-equality run boundaries along `order`. `sorted_rows` is the window
    matrix in sorted order (int32[n_v, v]) for "kernel" and the packed
    words (position-indexed) for "torch" and "radix".
    """
    if impl == "kernel":
        out = kernel_bitonic_sort(window_rows(xp, n_v, v))[:n_v]
        srt = out[:, :v]
        is_start = torch.ones(n_v, dtype=torch.bool, device=xp.device)
        is_start[1:] = (srt[1:] != srt[:-1]).any(dim=1)
        return out[:, v].long(), is_start, srt
    words, bits = window_words(xp, n_v, v, lo, hi)
    order = argsort_words(words, bits, impl)
    if impl == "radix":
        return order, dense_rank_gathered(words, order)[1], words
    is_start = torch.ones(n_v, dtype=torch.bool, device=xp.device)
    is_start[1:] = rows_neq(words, order[1:], order[:-1])
    return order, is_start, words


# --------------------------------------------------------------------------
# prefix-doubling base case
# --------------------------------------------------------------------------
def suffix_array_doubling_torch(x: torch.Tensor) -> torch.Tensor:
    """Prefix-doubling base case (Manber–Myers): ceil(log2 n) + 1 rounds,
    each one stable `torch.sort` of the packed key (rank, shifted + 1).
    x: int64[n], values in [0, 2³¹). Returns int64[n]."""
    n = len(x)
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)

    def dense_rank(k1, k2):
        s, perm = torch.sort((k1 << 32) | (k2 + 1), stable=True)
        boundary = torch.ones(n, dtype=torch.bool, device=x.device)
        boundary[1:] = s[1:] != s[:-1]
        rank = torch.empty(n, dtype=I64, device=x.device)
        rank[perm] = torch.cumsum(boundary, 0) - 1
        return rank, perm

    rank, perm = dense_rank(x, torch.zeros_like(x))
    for s in range(steps):
        h = 1 << s
        shifted = torch.full_like(rank, -1)
        if h < n:
            shifted[:n - h] = rank[h:]
        rank, perm = dense_rank(rank, shifted)
    return perm


# --------------------------------------------------------------------------
# Lemma-1 tie resolution
# --------------------------------------------------------------------------
#: tie sets larger than max(this, n_v/8) are first shrunk by stride-doubling
#: refinement rounds before any comparator runs.
_TIEBREAK_COMPACT_MAX = 1024


def _resolve_ties(order, is_start, rank, shifts, lam1, lam2, v: int,
                  n_v: int) -> torch.Tensor:
    """Steps 2–4 second half: refine the window-sorted candidate order.

    `order` sorts all n_v suffixes by their v-character window; `is_start`
    marks tie-group boundaries along it. While the tie set is large,
    stride-doubling refinement rounds shrink it using the group ranks
    themselves as keys (Manber–Myers, seeded at resolution v); the residue
    is resolved by the Lemma-1 comparator on a compacted payload
    (`lemma1_order`). `order` and `is_start` are updated in place; returns
    `order`.
    """
    run_start, sizes = run_state(is_start)
    r_pos = torch.empty(n_v, dtype=I64, device=order.device)
    r_pos[order] = run_start
    unresolved = sizes > 1
    U = int(unresolved.sum())
    if U == 0:
        return order

    # Refinement: slots in one run share their first `stride` characters,
    # so (r_pos[i], r_pos[i + stride]) is a valid refinement key.
    stride = v
    cap = max(_TIEBREAK_COMPACT_MAX, n_v >> 3)
    while U > cap and stride < n_v:
        count("repro_torch.dcv.refine_rounds")
        with span("repro_torch.dcv.refine"):
            sl = compact(unresolved, U)
            p = order[sl]
            nxt = p + stride
            key = torch.where(nxt < n_v, r_pos[nxt.clamp(max=n_v - 1)], -1)
            packed = (r_pos[p] << 32) | (key + 1)             # both < 2^31
            pk, local = torch.sort(packed, stable=True)
            order[sl] = p[local]
            # run starts re-emerge via the high bits; interiors refine.
            is_start[sl[1:]] = pk[1:] != pk[:-1]
            run_start, sizes = run_state(is_start)
            r_pos[order] = run_start
            unresolved = sizes > 1
            U = int(unresolved.sum())
        stride *= 2
    if U == 0:
        return order

    # Lemma-1 comparator on the compacted ties only.
    count("repro_torch.dcv.lemma1_rows", U)
    with span("repro_torch.dcv.lemma1"):
        sl = compact(unresolved, U)
        p = order[sl]
        klass = p % v
        order[sl] = lemma1_order(p, sl - run_start[sl], sizes[sl],
                                 rank[p[:, None] + shifts[klass]], klass,
                                 lam1, lam2, len(rank))
    return order


# --------------------------------------------------------------------------
# legacy fully-fused bitonic path (sort_impl="bitonic")
# --------------------------------------------------------------------------
#: the chars of the payload's pad rows: above every character (text values
#: are below 2³¹), so pads sort after every real suffix.
_PAD_CHAR = 2 ** 31


def _encode_sample(xp: torch.Tensor, sample_pos: torch.Tensor, v: int):
    """Step 1 (first half): rank the super-characters (v-character windows)
    of the sample positions with a key sort of the window rows. Returns
    (X' int64[m], the number of distinct windows, the sample ranks that
    are final when all windows are distinct)."""
    m = len(sample_pos)
    device = xp.device
    win = xp[sample_pos[:, None] + torch.arange(v, device=device)[None, :]]
    perm = sort_rows_with_index(win, v)
    ws = win[perm]
    boundary = torch.ones(m, dtype=torch.bool, device=device)
    boundary[1:] = (ws[1:] != ws[:-1]).any(dim=1)
    ranks_sorted = torch.cumsum(boundary, 0) - 1
    xs = torch.empty(m, dtype=I64, device=device)
    xs[perm] = ranks_sorted
    sa_rank = torch.empty(m, dtype=I64, device=device)
    sa_rank[perm] = torch.arange(m, device=device)
    return xs, int(ranks_sorted[-1]) + 1, sa_rank


def _fused_final_sort(xp, sample_pos, sa_rank, shifts, lam1, lam2, v: int,
                      n_v: int) -> torch.Tensor:
    """Fused Steps 2–4: one comparator-bitonic sort of all n_v suffixes by
    (window, Lemma-1 rank `rank[i + Λ[k_i][k_j]]`, position).

    O(n log² n) compare-exchanges over the full payload: the JAX package
    keeps it as the executable reference of the keyed paths and as a
    regression row. Returns int64[n_v], the positions in suffix order."""
    device = xp.device
    rank = torch.full((n_v + v,), -1, dtype=I64, device=device)
    rank[sample_pos] = sa_rank
    pos = torch.arange(n_v, device=device)
    klass = pos % v
    rvals = rank[pos[:, None] + shifts[klass]]               # [n_v, |D|]
    chars = xp[pos[:, None] + torch.arange(v, device=device)[None, :]]
    n2 = next_pow2(n_v)
    pad = n2 - n_v
    payload = {
        "chars": torch.cat([chars, torch.full((pad, v), _PAD_CHAR, dtype=I64,
                                              device=device)]),
        "ranks": torch.cat([rvals, rvals.new_zeros((pad, rvals.shape[1]))]),
        "klass": torch.cat([klass, klass.new_zeros(pad)]),
        "idx": torch.arange(n2, device=device),
    }

    def lt_fn(a, b):
        char_lt, char_eq = lex_lt_int(a["chars"], b["chars"])
        ka, kb = a["klass"], b["klass"]
        ra = a["ranks"].gather(1, lam1[ka, kb][:, None])[:, 0]
        rb = b["ranks"].gather(1, lam2[ka, kb][:, None])[:, 0]
        return torch.where(char_eq & (ra != rb), ra < rb,
                           torch.where(char_eq, a["idx"] < b["idx"], char_lt))

    return bitonic_sort(payload, lt_fn)["idx"][:n_v]


# --------------------------------------------------------------------------
# recursion driver
# --------------------------------------------------------------------------
def suffix_array_torch(
    x,
    v: int = 3,
    schedule=accelerated_next_v,
    base_threshold: int | None = None,
    sort_impl: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Suffix array of x (ints ≥ 0, < 2³¹) — vectorised PyTorch DC-v.

    Parameters
    ----------
    x : 1-D integer sequence (tokens / bytes): array-like or tensor.
    v : initial difference-cover modulus (paper Algorithm 1).
    schedule : ``(v, |D|, m) -> v'`` — the paper's accelerated v-schedule
        by default.
    base_threshold : recursion cutoff; below it a prefix-doubling sort runs
        directly. ``None`` means 256.
    sort_impl : one of `repro_torch.core.compat.SORT_IMPLS`.
    device : where the build runs; ``"cuda"`` unless the caller asks for
        ``"cpu"``.

    Returns int32[n] on `device`, a permutation of range(n).
    """
    dev = resolve_device(device)
    impl = resolve_sort_impl(sort_impl, dev)
    if base_threshold is None:
        base_threshold = 256
    x = torch.as_tensor(x).to(device=dev, dtype=I64).reshape(-1)
    n = len(x)
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)

    def rec(x: torch.Tensor, v: int, hi: int) -> torch.Tensor:
        if len(x) <= max(base_threshold, v, 4):
            with span("repro_torch.dcv.base"):
                return suffix_array_doubling_torch(x)
        with span("repro_torch.dcv.level"):
            return level(x, v, hi)

    def level(x: torch.Tensor, v: int, hi: int) -> torch.Tensor:
        n = len(x)
        v = int(min(max(v, 3), n))
        n_v = v * -(-n // v)
        xp = padded_text(x, n_v, v)
        (sample_pos, inv_sample, in_D, shifts,
         lam1, lam2) = level_constants(n_v, v, dev)
        m = len(sample_pos)
        if impl == "bitonic":
            xs, n_distinct, sa_rank = _encode_sample(xp, sample_pos, v)
            if n_distinct != m:
                sa_sub = rec(xs, schedule(v, len(cover_tables(v).D), m),
                             n_distinct - 1)
                sa_rank[sa_sub] = torch.arange(m, device=dev)
            sa_full = _fused_final_sort(xp, sample_pos, sa_rank, shifts,
                                        lam1, lam2, v, n_v)
            return sa_full[sa_full < n]
        lo = -(n_v + 2 * v - n)

        # --- ONE window sort feeds Step 1 AND Steps 2–4 ---
        count("repro_torch.dcv.levels")
        with span("repro_torch.dcv.window_order"):
            order, is_start, rep = window_order(xp, n_v, v, lo, hi, impl)

        # Step 1: sample ranks = the window order filtered to sample
        # positions (a stable subsequence of a sorted sequence is sorted).
        with span("repro_torch.dcv.sample_rank"):
            s_slots = compact(in_D[order % v], m)
            sp = order[s_slots]                   # sample pos, window-sorted
            if impl == "kernel":
                ranks_sorted, n_distinct = dense_rank_sorted(rep[s_slots])
            elif impl == "radix":
                ranks_sorted, _, n_distinct = dense_rank_gathered(rep, sp)
            else:
                sb = torch.ones(m, dtype=torch.bool, device=dev)
                sb[1:] = rows_neq(rep, sp[1:], sp[:-1])
                ranks_sorted = torch.cumsum(sb, 0) - 1
                n_distinct = ranks_sorted[-1] + 1
            n_distinct = int(n_distinct)
            si = inv_sample[sp]
            sa_rank = torch.empty(m, dtype=I64, device=dev)
            if n_distinct == m:
                sa_rank[si] = torch.arange(m, device=dev)
            else:
                xs = torch.empty(m, dtype=I64, device=dev)
                xs[si] = ranks_sorted.long()
        if n_distinct != m:
            sa_sub = rec(xs, schedule(v, len(cover_tables(v).D), m),
                         n_distinct - 1)
            sa_rank[sa_sub] = torch.arange(m, device=dev)

        # Steps 2–4: refine the shared window order with Lemma-1 ranks.
        with span("repro_torch.dcv.resolve_ties"):
            rank = torch.full((n_v + v,), -1, dtype=I64, device=dev)
            rank[sample_pos] = sa_rank
            sa_full = _resolve_ties(order, is_start, rank, shifts, lam1,
                                    lam2, v, n_v)
        # Pad suffixes start below every real character, so all n_v - n of
        # them come first and the real suffixes are the tail.
        return sa_full[n_v - n:]

    return rec(x, v, int(x.max())).to(torch.int32)
