"""Packed sort words and tie runs: the formats the port's three builders
share.

The dense DC-v build (`core.dcv_torch`), the sparse head sort
(`sparse.construct`) and the BSP rank-local key sorts (`bsp.psort`) all
order rows of non-negative integer columns the same way: the columns are
packed most-significant first into int64 words of at most 63 bits
(`pack_words`; torch sorts signed int64 only, so the sign bit stays
clear), and the word lists are argsorted (`argsort_words`). Comparing two
rows' word lists lexicographically equals comparing their columns.

After a sort, rows with equal keys form runs along the order: `run_state`
gives each slot its run's start and size (`run_starts` the start alone),
`compact` lists the slots of a mask without a host read, and
`lemma1_order` orders the members of each run by the paper's Lemma-1
comparator.
"""
from __future__ import annotations

import torch

from ..kernels.ops import lemma1_merge, radix_argsort

#: the most bits a packed word holds.
WORD_BITS = 63
I64 = torch.int64


def word_bits(widths) -> list[int]:
    """The bit width of each word `pack_words` makes of columns `widths`
    bits wide (each in [1, 63]): a column joins the last word while the
    word stays within 63 bits and opens a new word otherwise, so columns
    of one width `bits` go `63 // bits` to a word."""
    bits = []
    for w in widths:
        if bits and bits[-1] + w <= WORD_BITS:
            bits[-1] += w
        else:
            bits.append(w)
    return bits


def pack_words(columns, widths) -> tuple[list[torch.Tensor], list[int]]:
    """Pack non-negative int64 columns, most significant first, into int64
    words of at most 63 bits.

    Column c holds values below 2**widths[c], widths[c] ≥ 1. `columns` may
    be a generator, so a caller can make each column just before it is
    packed. Returns (words, `word_bits(widths)`): word k is below
    2**bits[k]."""
    widths = list(widths)
    bits = word_bits(widths)
    words, left = [], 0
    for col, w in zip(columns, widths):
        if left:                           # room left in the last word
            words[-1] = (words[-1] << w) | col
        else:
            words.append(col.contiguous())
            left = bits[len(words) - 1]
        left -= w
    return words, bits


def argsort_words(words: list[torch.Tensor], bits: list[int],
                  impl: str = "radix") -> torch.Tensor:
    """int64[N]: the stable lexicographic argsort of the word lists
    (words[0][i], ..., words[K-1][i]); equal rows stay in index order.

    ``"radix"`` sorts with `radix_argsort`, the LSD radix sort on the
    hand-written histogram and scatter kernels (their plain versions on a
    CPU tensor), which reads `bits`; ``"torch"`` with one stable
    `torch.sort` pass a word, last word first."""
    if impl == "radix":
        return radix_argsort(words, bits)
    if impl != "torch":
        raise ValueError(f"unknown word sort {impl!r}")
    order = torch.arange(len(words[0]), device=words[0].device)
    for w in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    return order


def compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Ascending indices of the True entries of `mask`, whose number the
    caller knows (`count`) — `torch.nonzero` without its host read."""
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, count)
    out = torch.empty(count + 1, dtype=I64, device=mask.device)
    out.scatter_(0, dest, torch.arange(len(mask), device=mask.device))
    return out[:count]


def _run_table(is_start: torch.Tensor):
    """(run_id, start_of): each slot's run, and each run's first slot."""
    n = len(is_start)
    run_id = torch.cumsum(is_start, 0) - 1
    # start_of[r] = first slot of run r; the entry after the last run keeps
    # n (the non-start slots all scatter into start_of[n], read only when
    # every slot starts a run, and then nothing scatters there).
    start_of = torch.full((n + 1,), n, dtype=I64, device=is_start.device)
    start_of.scatter_(0, torch.where(is_start, run_id, n),
                      torch.arange(n, device=is_start.device))
    return run_id, start_of


def run_starts(is_start: torch.Tensor) -> torch.Tensor:
    """Per slot: the slot where its run starts. `is_start[0]` must be
    True. One cumsum, one scatter and one gather: no scan in series."""
    run_id, start_of = _run_table(is_start)
    return start_of[run_id]


def run_state(is_start: torch.Tensor):
    """Per slot: the slot where its run starts, and the run's size.
    `is_start[0]` must be True."""
    run_id, start_of = _run_table(is_start)
    run_start = start_of[run_id]
    return run_start, start_of[run_id + 1] - run_start


def lemma1_order(p, lane, width, rvals, klass, lam1, lam2,
                 rank_bound: int) -> torch.Tensor:
    """Order the members of each tie group by the Lemma-1 comparator.

    `p` [U] lists the tied rows in slot order, each group contiguous and
    ascending in `p`; `lane` is a row's offset inside its group, `width`
    the group's size, `rvals` [U, |D|] and `klass` [U] the rows' sample
    ranks (each in [-1, rank_bound)) and classes. Ties of the comparator
    fall to `p`.

    Rows of one class compare by one column, their key
    `rvals[i, lam1[k, k]]`. So one stable radix sort by (group, class,
    key) orders every class segment, and one `lemma1_merge` launch places
    each row among its group's other classes by binary search. One route
    for every group width; nothing is read back to the host. Returns p
    reordered."""
    n = len(p)
    key = rvals.gather(1, lam1[klass, klass][:, None])[:, 0] + 1
    key_bits = int(rank_bound).bit_length()
    start = torch.arange(n, device=p.device) - lane
    perm = radix_argsort([start, (klass << key_bits) | key],
                         [max(1, (n - 1).bit_length()),
                          (lam1.shape[0] - 1).bit_length() + key_bits])
    return lemma1_merge(p[perm], klass[perm], rvals[perm], lane, width, lam1,
                        lam2)
