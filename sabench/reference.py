"""The plain reference: the corpus layout and the suffix array, in stock
PyTorch operations, written from the documented semantics
and sharing nothing with the program under test.

Layout (the program's documented `from_docs` layout): the documents in the
build's order, data values shifted up by the document count, document k
followed by the separator k. Separators are unique and below every data
value, so no suffix comparison crosses a document boundary.

`suffix_array` is prefix doubling: ranks of the first 2^i symbols of every
suffix, refined by one stable sort of (rank, rank 2^i further on) a round
until every rank is distinct.

The control breaks the layout's guarantee: ``separators="shared"`` ends
every document with the same value, so suffixes that tie to a document's
end compare on into the next document.
"""
from __future__ import annotations

import torch

SEPARATORS = ("unique", "shared")


def encode(data: torch.Tensor, lengths: torch.Tensor, order=None, *,
           separators: str = "unique") -> torch.Tensor:
    """The text of the documents (`data` back to back, split by `lengths`)
    taken in `order` (document `order[k]` at place k), int64 on `data`'s
    device."""
    if separators not in SEPARATORS:
        raise ValueError(f"unknown separators {separators!r}")
    dev = data.device
    n_docs = len(lengths)
    starts = torch.cumsum(lengths, 0) - lengths
    if order is not None:
        order = torch.as_tensor(order, device=dev)
        lengths, starts = lengths[order], starts[order]
    seg = lengths + 1
    out_start = torch.cumsum(seg, 0) - seg
    text = torch.empty(int(seg.sum()), dtype=torch.int64, device=dev)
    ids = torch.arange(n_docs, device=dev)
    text[out_start + lengths] = ids if separators == "unique" else 0
    doc = torch.repeat_interleave(torch.arange(n_docs, device=dev), lengths)
    step = torch.arange(int(lengths.sum()), device=dev) - \
        torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths, lengths)
    text[out_start[doc] + step] = data[starts[doc] + step] + n_docs
    return text


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """The suffix array of `text` (int64), by prefix doubling."""
    n = text.numel()
    if n < 2:
        return torch.zeros(n, dtype=torch.int64, device=text.device)
    rank = torch.unique(text, sorted=True, return_inverse=True)[1]
    h = 1
    while True:
        key = rank * (n + 1)
        key[:n - h] += rank[h:] + 1            # 0 past the end: shorter first
        key, sa = torch.sort(key, stable=True)
        new = torch.ones(n, dtype=torch.int64, device=text.device)
        new[0] = 0
        torch.ne(key[1:], key[:-1], out=new[1:])
        del key
        ranks_sorted = torch.cumsum(new, 0)
        del new
        if int(ranks_sorted[-1]) == n - 1:
            return sa
        rank = torch.empty_like(rank)
        rank[sa] = ranks_sorted
        del ranks_sorted, sa
        h *= 2
