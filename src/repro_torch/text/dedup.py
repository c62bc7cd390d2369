"""Exact-substring deduplication over the port's suffix arrays (Lee et al.
2022, "Deduplicating Training Data Makes Language Models Better", use
suffix arrays for exactly this).

The port of `repro.text.dedup`. The suffix array is built on the device
(`repro_torch.api.SuffixArrayIndex`, ``device="cuda"`` unless the caller
asks for ``"cpu"``); the drop rule runs in numpy on the host copies of the
text and SA (`SuffixArrayIndex._host_arrays`), over the index's LCP array.

The drop rule (shared by every path)
------------------------------------
A position ``p`` is **flagged** when the ``min_len``-gram starting at ``p``
also occurs at an *earlier* corpus position (``keep_first=True``; the
symmetric rule flags non-latest occurrences for ``keep_first=False``).
The drop mask is the union of ``[p, p + min_len)`` over flagged ``p``.

That is the union of ``[p, p + LPF(p))`` over positions whose longest
previous factor reaches ``min_len``: a match of length ``L ≥ min_len`` at
``p`` flags the shifted starts ``p + j`` (``j ≤ L - min_len``) too, and
their fixed-width intervals tile ``[p, p + L)``. The rule is

* **exact** — every non-leftmost occurrence of a repeat ≥ ``min_len`` is
  dropped, even when three or more occurrences interleave in SA order; and
* **prefix-stable** — whether ``p`` is dropped depends only on content at
  positions ``≤ p``, so the streaming pass over document shards
  (`repro_torch.data.pipeline.StreamingDedup`) gives byte-identical output
  to a monolithic build of the same corpus (`dedup_docs`).

``DEDUP_MIN_LEN = 48`` is the one default threshold of `dedup_corpus`,
`dedup_docs` and `repro_torch.data.pipeline.PipelineConfig`. The legacy
``sa_builder=`` keyword still works but is deprecated.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..api import SAOptions, SuffixArrayIndex

#: the one documented default for exact-substring dedup thresholds
#: (Lee et al. 2022 use 50 BPE tokens; 48 is the byte-level pin).
DEDUP_MIN_LEN = 48


@dataclass
class DedupReport:
    n_chars: int
    dup_chars: int            # chars inside repeated regions (incl. firsts)
    spans: list
    dropped_chars: int = 0    # chars actually removed by the drop rule

    @property
    def dup_fraction(self) -> float:
        return self.dup_chars / max(self.n_chars, 1)

    @property
    def dropped_fraction(self) -> float:
        return self.dropped_chars / max(self.n_chars, 1)


def _index_of(corpus: np.ndarray, sa_builder, options: SAOptions | None,
              device) -> SuffixArrayIndex:
    if sa_builder is not None:
        warnings.warn("dedup(sa_builder=...) is deprecated; pass "
                      "options=SAOptions(backend=...) instead",
                      DeprecationWarning, stacklevel=3)
        return SuffixArrayIndex(corpus, sa_builder(corpus), device=device)
    return SuffixArrayIndex.build(corpus, options, device=device)


def find_duplicates(corpus: np.ndarray, min_len: int = DEDUP_MIN_LEN,
                    sa_builder=None, options: SAOptions | None = None, *,
                    device="cuda") -> DedupReport:
    """`DedupReport` of `corpus` from a suffix array built on `device`."""
    corpus = np.asarray(corpus)
    index = _index_of(corpus, sa_builder, options, device)
    return report_duplicates(index, min_len)


def report_duplicates(index: SuffixArrayIndex, min_len: int) -> DedupReport:
    """DedupReport from an already-built index (SA/LCP are reused)."""
    spans = index.duplicate_spans(min_len)
    dup = sum(e - s for s, e in spans)
    return DedupReport(n_chars=index.n, dup_chars=int(dup), spans=spans)


def duplicate_gram_flags(index: SuffixArrayIndex, min_len: int,
                         keep_first: bool = True) -> np.ndarray:
    """bool[n] over *encoded* positions: True where the ``min_len``-gram
    starting there also occurs at an earlier (``keep_first=True``) or later
    (``keep_first=False``) encoded position.

    Vectorised over the SA + LCP: consecutive SA ranks whose pairwise LCP
    is ≥ ``min_len`` form a *run*, and a run is exactly the occurrence set
    of one ``min_len``-gram (unique separators stop comparisons at document
    boundaries, so runs never cross documents). Within a run, every member
    but the extreme-position one is flagged.
    """
    n = index.n
    flags = np.zeros(n, bool)
    if n == 0 or min_len <= 0 or min_len > n:
        return flags
    sa = index._host_arrays()[1].astype(np.int64)
    lcp = index.lcp
    new_run = np.ones(n, bool)
    new_run[1:] = lcp[1:] < min_len
    run_id = np.cumsum(new_run) - 1
    n_runs = int(run_id[-1]) + 1
    if keep_first:
        extreme = np.full(n_runs, np.iinfo(np.int64).max)
        np.minimum.at(extreme, run_id, sa)
    else:
        extreme = np.full(n_runs, -1)
        np.maximum.at(extreme, run_id, sa)
    flags[sa[sa != extreme[run_id]]] = True
    return flags


def gram_drop_mask(flags: np.ndarray, min_len: int) -> np.ndarray:
    """Union of ``[p, p + min_len)`` over flagged positions, as bool[n].

    +1/−1 deltas and a cumsum. Flagged positions always carry ``min_len``
    real characters, so an interval never spills past a document separator
    or the end of the text.
    """
    n = len(flags)
    at = np.flatnonzero(flags)
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, at, 1)
    np.add.at(delta, np.minimum(at + min_len, n), -1)
    return np.cumsum(delta[:n]) > 0


def dedup_corpus(corpus: np.ndarray, min_len: int = DEDUP_MIN_LEN,
                 sa_builder=None, keep_first: bool = True,
                 options: SAOptions | None = None, *, device="cuda"
                 ) -> tuple[np.ndarray, DedupReport]:
    """Remove all but one occurrence of repeated substrings ≥ ``min_len``.

    ``keep_first=True`` (the Lee et al. policy) keeps the earliest copy of
    each repeat; ``keep_first=False`` keeps the latest. Returns
    ``(deduped_corpus, report)``: the report's ``spans`` describe every
    repeated region (the kept copy included), ``dropped_chars`` counts what
    was removed. An empty corpus round-trips to an empty corpus.
    """
    corpus = np.asarray(corpus)
    index = _index_of(corpus, sa_builder, options, device)
    report = report_duplicates(index, min_len)
    if not report.spans:
        return corpus, report
    flags = duplicate_gram_flags(index, min_len, keep_first=keep_first)
    drop = gram_drop_mask(flags, min_len)
    report.dropped_chars = int(drop.sum())
    return corpus[~drop], report


def dedup_docs(docs, min_len: int = DEDUP_MIN_LEN, *,
               options: SAOptions | None = None, sigma: int | None = None,
               keep_first: bool = True, device="cuda"
               ) -> tuple[list, DedupReport]:
    """Document-aware monolithic dedup: one suffix array over all ``docs``
    on `device` (sentinel-separator layout, so no repeat spans a document
    boundary), the gram drop rule applied in global document order.

    Returns ``(deduped_docs, report)``: ``deduped_docs[i]`` is ``docs[i]``
    (int64) with its dropped positions removed. The streaming data plane
    (`repro_torch.data.pipeline.StreamingDedup`) is byte-identical to it.
    """
    index = SuffixArrayIndex.from_docs(docs, options, sigma=sigma,
                                       device=device)
    report = report_duplicates(index, min_len)
    report.n_chars = int(sum(len(np.asarray(d).ravel()) for d in docs))
    flags = duplicate_gram_flags(index, min_len, keep_first=keep_first)
    drop = gram_drop_mask(flags, min_len)
    report.dropped_chars = int(drop.sum())
    text = index._host_arrays()[0]
    return [text[s:e][~drop[s:e]] - index.shift
            for s, e in zip(index.doc_starts, index._doc_ends)], report
