"""`SparseSuffixArrayIndex` — the sampled-position index behind the facade.

The port of `repro.sparse.index`. It subclasses
`repro_torch.api.SuffixArrayIndex` and keeps its exact query semantics for
every pattern of length ≥ ``sample_rate``: `count_batch` / `locate_batch`
/ `contains_batch` / `locate_docs_batch` / `longest_match` return the
dense index's results. ``self.sa`` holds only the suffix order of
positions ``{0, s, 2s, ...}`` (int32 on the index's device), so the SA is
s× smaller; patterns shorter than the rate raise `PatternTooShortError`
when they are encoded, before any device work.

Operations that need the rank of every text position (`sa_ranges_batch`,
`ngram_stats`, `duplicate_spans`, `cross_doc_duplicates`) raise
`NotImplementedError` and point to the dense index, as in the reference.
The serving protocol (`stage_encoded` / `ranges_staged`) answers with
virtual ``(0, count)`` ranges.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.index import SuffixArrayIndex, stage_docs
from ..api.options import SAOptions
from ..api.query import QueryBatch
from ..core.compat import resolve_device
from ..trace import span
from .construct import build_sparse_suffix_array, sparse_lcp
from .query import sparse_ranges, verify_alignments


class PatternTooShortError(ValueError):
    """Pattern shorter than the index's ``sample_rate``.

    A sparse index anchors occurrences only of patterns with length ≥ its
    sampling stride. Raised when the pattern is encoded, so callers can
    tell "this index cannot answer that" from a genuine 0 count. A
    `ValueError`, so pattern-validation handlers keep working.
    """

    def __init__(self, pattern_len: int, sample_rate: int):
        self.pattern_len = int(pattern_len)
        self.sample_rate = int(sample_rate)
        super().__init__(
            f"pattern of length {pattern_len} is shorter than this sparse "
            f"index's sample_rate={sample_rate}; sparse queries are exact "
            f"only for patterns of length ≥ sample_rate — use a dense "
            f"index (sample_rate=1) for shorter patterns")


class SparseSuffixArrayIndex(SuffixArrayIndex):
    """Suffix-array index over every ``sample_rate``-th text position.

    Construction (`build` / `from_docs`) runs `build_sparse_suffix_array`
    on the index's device; queries run the two-level plan of
    `repro_torch.sparse.query` (per-alignment double binary search on the
    device, head verification on the host). Positions, `doc_of` /
    `doc_offset` and document coordinates are those of the dense index:
    the text is stored whole, only the suffix order is sampled.
    """

    def __init__(self, text, sa, *, sample_rate: int, doc_starts=None,
                 shift: int = 0, options: SAOptions | None = None,
                 lcp=None, sigma: int | None = None, device="cuda"):
        s = int(sample_rate)
        if s < 2:
            raise ValueError(
                f"SparseSuffixArrayIndex needs sample_rate ≥ 2, got {s} "
                f"(sample_rate=1 is the dense SuffixArrayIndex)")
        self.sample_rate = s        # before super().__init__: _check_shapes
        super().__init__(text, sa, doc_starts=doc_starts, shift=shift,
                         options=options, lcp=lcp, sigma=sigma,
                         device=device)
        if self.options.sample_rate != s:
            # fingerprint() must describe the stored structure even when a
            # caller passes a mismatched plan
            self.options = self.options.replace(sample_rate=s)

    def _check_shapes(self) -> None:
        ns = -(-self.n // self.sample_rate)
        if tuple(self.sa.shape) != (ns,):
            raise ValueError(
                f"sparse sa shape {tuple(self.sa.shape)} != ({ns},) = "
                f"ceil(n={self.n} / sample_rate={self.sample_rate})")

    # ----------------------------------------------------------- construct
    @classmethod
    def build(cls, text, options: SAOptions | None = None, *,
              sigma: int | None = None, device="cuda", **overrides):
        """Index a single document at ``options.sample_rate`` (≥ 2). The
        sparse build bypasses the builder cache, whose contract is the
        dense full-length SA."""
        opts = options if options is not None else SAOptions()
        if overrides:
            opts = opts.replace(**overrides)
        with span("repro_torch.index.upload"):
            text = torch.as_tensor(np.asarray(text, np.int64),
                                   device=resolve_device(device))
        sa = build_sparse_suffix_array(text, opts.sample_rate, device=device)
        return cls(text, sa, sample_rate=opts.sample_rate, shift=0,
                   options=opts, sigma=sigma, device=device)

    @classmethod
    def from_docs(cls, docs, options: SAOptions | None = None, *,
                  sigma: int | None = None, device="cuda", **overrides):
        """Index documents in the dense `from_docs` sentinel-separator
        layout: positions and (doc, offset) mapping are the same."""
        opts = options if options is not None else SAOptions()
        if overrides:
            opts = opts.replace(**overrides)
        text, starts, n_docs = stage_docs(docs, device)
        sa = build_sparse_suffix_array(text, opts.sample_rate, device=device)
        return cls(text, sa, sample_rate=opts.sample_rate, doc_starts=starts,
                   shift=n_docs, options=opts, sigma=sigma, device=device)

    # ----------------------------------------------------------- structure
    @property
    def ns(self) -> int:
        """Number of sampled (indexed) positions: ceil(n / sample_rate)."""
        return len(self.sa)

    @property
    def min_pattern_len(self) -> int:
        """Shortest pattern this index answers exactly (= sample_rate)."""
        return self.sample_rate

    @property
    def lcp(self) -> np.ndarray:
        """Sparse LCP array (consecutive sampled suffixes), lazy + cached."""
        if self._lcp is None:
            self._lcp = sparse_lcp(*self._host_arrays())
        return self._lcp

    # ------------------------------------------------------------- queries
    def _encode_pattern(self, pattern) -> np.ndarray:
        pat = super()._encode_pattern(pattern)
        if len(pat) < self.sample_rate:
            raise PatternTooShortError(len(pat), self.sample_rate)
        return pat

    def _counts_from_batch(self, batch: QueryBatch, *,
                           staged=None) -> np.ndarray:
        lo, hi = sparse_ranges(self, batch, staged=staged)
        counts, _ = verify_alignments(self, batch, lo, hi)
        return counts

    def count_batch(self, patterns) -> np.ndarray:
        """Exact occurrence counts: one per-alignment search on the device
        plus one vectorised host verification pass for the whole batch."""
        return self._counts_from_batch(self._as_batch(patterns))

    def locate_batch(self, patterns) -> list:
        """Sorted encoded start positions per pattern — equal to the dense
        index's `locate_batch` for patterns ≥ sample_rate."""
        qb = self._as_batch(patterns)
        lo, hi = sparse_ranges(self, qb)
        _, positions = verify_alignments(self, qb, lo, hi,
                                         want_positions=True)
        return positions

    def sa_ranges_batch(self, patterns):
        raise NotImplementedError(
            "a sparse index has no dense SA rank space — [lo, hi) ranges "
            "over all n suffixes do not exist at sample_rate > 1; use "
            "count_batch / locate_batch (exact), or a dense index")

    # ------------------------------------------------- serving-tier protocol
    # stage_encoded is the dense index's: the same batch, staged the same way

    def ranges_staged(self, work) -> tuple[np.ndarray, np.ndarray]:
        """Resolve a staged work item to **virtual** ``(0, count)`` ranges.

        The serving tier reads ranges only as ``hi - lo`` widths; a sparse
        index has no dense rank space to report, so it returns ``[0,
        count)`` per pattern, whose widths are exact."""
        batch, staged = work
        counts = self._counts_from_batch(batch, staged=staged)
        return np.zeros(len(counts), np.int64), counts

    # ---------------------------------------------------------- statistics
    def ngram_stats(self, k: int):
        raise NotImplementedError(
            "ngram_stats needs the rank of every text position (dense SA + "
            "LCP); build a dense index (sample_rate=1) for corpus stats")

    def duplicate_spans(self, min_len: int):
        raise NotImplementedError(
            "duplicate_spans needs the dense SA + LCP; build a dense index "
            "(sample_rate=1) for this report")

    def cross_doc_duplicates(self, min_len: int):
        raise NotImplementedError(
            "cross_doc_duplicates needs the dense SA + LCP; build a dense "
            "index (sample_rate=1) for this report")

    def __repr__(self) -> str:
        return (f"SparseSuffixArrayIndex(n={self.n}, ns={self.ns}, "
                f"sample_rate={self.sample_rate}, n_docs={self.n_docs}, "
                f"device={self.device}, "
                f"lcp={'cached' if self._lcp is not None else 'lazy'})")
