"""DEPRECATED shim — use `repro_torch.api.SuffixArrayIndex` instead.

The port of `repro.text.corpus_sa`. The multi-document sentinel-separator
layout and its queries live in `repro_torch.api.index.SuffixArrayIndex`
(`from_docs`, `count`, `locate`, `cross_doc_duplicates`). This module keeps
the old `CorpusSA` struct (numpy arrays on the host) and its free
functions on top of the facade; each entry point emits a
`DeprecationWarning`.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..api import SAOptions, SuffixArrayIndex, encode_docs


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.text.corpus_sa.{old} is deprecated; use "
                  f"{new}", DeprecationWarning, stacklevel=3)


@dataclass
class CorpusSA:
    text: np.ndarray          # concatenated, separator-encoded corpus
    sa: np.ndarray            # suffix array over `text`
    doc_starts: np.ndarray    # start offset of each document in `text`
    n_docs: int
    sep_count: int            # separators (excluded from queries)
    device: str = "cuda"      # where `as_index` puts the arrays

    def doc_of(self, pos):
        """Document index owning text position(s) `pos` (scalar or array):
        host arithmetic over `doc_starts`."""
        return self.as_index(device="cpu").doc_of(pos)

    def as_index(self, device=None) -> SuffixArrayIndex:
        """The `repro_torch.api.SuffixArrayIndex` view of this struct, on
        `device` (default: the device it was built on)."""
        return SuffixArrayIndex(self.text, self.sa,
                                doc_starts=self.doc_starts,
                                shift=self.n_docs,
                                device=self.device if device is None
                                else device)


def build_corpus_sa(docs: list, sa_builder=None,
                    options: SAOptions | None = None, *,
                    device="cuda") -> CorpusSA:
    """DEPRECATED: use `SuffixArrayIndex.from_docs(docs, options)`.

    `sa_builder` (legacy) is honoured when given: it is called directly on
    the encoded text. Otherwise the facade builds on `device` under
    `options`."""
    _deprecated("build_corpus_sa",
                "repro_torch.api.SuffixArrayIndex.from_docs")
    device = str(device)
    if len(docs) == 0:
        return CorpusSA(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int64), 0, 0, device)
    if sa_builder is not None:
        text, starts, n_docs = encode_docs(docs)
        index = SuffixArrayIndex(text, sa_builder(text), doc_starts=starts,
                                 shift=n_docs, device=device)
    else:
        index = SuffixArrayIndex.from_docs(docs, options, device=device)
    text, sa = index._host_arrays()
    return CorpusSA(text=text.astype(np.int32), sa=sa.astype(np.int32),
                    doc_starts=index.doc_starts, n_docs=index.n_docs,
                    sep_count=index.sep_count, device=device)


def count_occurrences(csa: CorpusSA, pattern) -> int:
    """DEPRECATED: use `SuffixArrayIndex.count(pattern)`.

    Keeps the *legacy* query semantics of this module, which the facade
    has since tightened: an empty pattern counts 0 (the facade counts n)
    and out-of-alphabet values count 0 (the facade raises ValueError)."""
    _deprecated("count_occurrences", "repro_torch.api.SuffixArrayIndex.count")
    idx = csa.as_index()
    pat = np.asarray(pattern, np.int64).ravel()
    if len(pat) == 0:
        return 0
    if idx.n and int(pat.max()) >= idx.sigma:
        return 0
    return idx.count(pattern)


def cross_doc_duplicates(csa: CorpusSA, min_len: int):
    """DEPRECATED: use `SuffixArrayIndex.cross_doc_duplicates(min_len)`."""
    _deprecated("cross_doc_duplicates",
                "repro_torch.api.SuffixArrayIndex.cross_doc_duplicates")
    return csa.as_index().cross_doc_duplicates(min_len)
