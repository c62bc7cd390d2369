"""`SuffixArrayIndex` — text + suffix array on the device, with queries.

The port of `repro.api.index`:

* `SuffixArrayIndex.build(text, options, device=)` — one document;
* `SuffixArrayIndex.from_docs(docs, options, device=)` — a multi-document
  corpus in the sentinel-separator layout (`encode_docs`: doc i ends with
  a unique separator of value i placed BELOW the shifted data alphabet,
  so no suffix comparison crosses a document boundary), made on the
  device by `stage_docs` (one concatenate on the host, one copy, one
  `encode_place` launch). A plan with ``sample_rate > 1`` builds a
  `repro_torch.sparse.SparseSuffixArrayIndex` instead;
* `index_from_numpy_state(state, device=)` — carry an index built
  elsewhere (text, sa, doc_starts, shift, sigma as numpy arrays and ints,
  e.g. those of a `repro.api.SuffixArrayIndex`) onto the device;
* `count_batch` / `locate_batch` / `contains_batch` / `sa_ranges_batch` /
  `locate_docs_batch` — many patterns, one vectorised search
  (`repro_torch.api.query`); `count` / `locate` / `locate_docs` are
  batches of one;
* `longest_match` / `longest_match_len` — the longest substring of a
  sequence that occurs in the index, by a binary search over lengths;
* `ngram_stats`, `duplicate_spans`, `cross_doc_duplicates` — over the
  lazily computed LCP array (Kasai, numpy on the host);
* `stage_encoded` / `ranges_staged` — the serving tier's two-step
  protocol (`repro_torch.serve`); `save` / `load` — persistence through
  `repro_torch.api.store`.

`text` (int64) and `sa` (int32) are tensors on the index's device; the
query methods return the numpy int64 arrays that the JAX package's index
returns. Pattern values must lie in ``[0, sigma)``; out-of-alphabet
values raise `ValueError`. The empty pattern is a prefix of every suffix,
so ``count([]) == n``; `locate([])` raises `ValueError`.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from ..core.compat import resolve_device
from ..kernels import ops
from ..text.lcp import lcp_kasai, repeated_substring_spans
from ..trace import count, span
from .build import build_suffix_array
from .options import SAOptions
from .query import QueryBatch, batch_ranges, stage_batch

INT32_MAX = 2 ** 31 - 1


def longest_match_len(index, seq) -> int:
    """Length of the longest substring of ``seq`` that occurs in ``index``.

    Works against anything with ``contains_batch``. Feasibility is
    monotone in the length (a substring's prefixes occur wherever it
    does), so a binary search over lengths resolves the answer with
    O(log |seq|) batched containment queries, each testing every window
    of the probed length at once. Out-of-alphabet values in ``seq`` can
    never match, so windows containing them are skipped, not errors.

    Against an index with a minimum answerable pattern length (a sparse
    index's ``min_pattern_len == sample_rate``), the search floors at that
    length: matches shorter than the floor report 0, matches at or above
    it are exact and equal to the dense answer.
    """
    seq = np.asarray(seq, np.int64).ravel()
    if len(seq) == 0 or index.n == 0:
        return 0
    ok = (seq >= 0) & (seq < max(index.sigma, 1))

    def feasible(m: int) -> bool:
        wins = np.lib.stride_tricks.sliding_window_view(seq, m)
        valid = np.flatnonzero(
            np.lib.stride_tricks.sliding_window_view(ok, m).all(axis=1))
        if not len(valid):
            return False
        return bool(np.any(index.contains_batch(list(wins[valid]))))

    floor = int(getattr(index, "min_pattern_len", 0))
    lo, hi = 0, len(seq)            # longest feasible is in [lo, hi]
    if floor > 1:
        if len(seq) < floor or not feasible(floor):
            return 0                # any true match is below the floor
        lo = floor
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if feasible(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _doc_parts(docs) -> tuple[list, np.ndarray]:
    """The documents as the parts of one concatenate, and their lengths
    (int64[n_docs]), in one pass over `docs`.

    An integer ndarray is its own part. Any other document (a list, a float
    array) is converted with ``np.asarray(d, np.int64)``, and each one is
    counted in ``repro_torch.index.docs_converted``. Raises `ValueError`
    naming the first document that is not 1-D."""
    parts, lengths, converted = docs, [], 0
    for i, d in enumerate(docs):
        if not isinstance(d, np.ndarray) or d.dtype.kind not in "iu":
            if parts is docs:
                parts = list(docs)
            parts[i] = d = np.asarray(d, np.int64)
            converted += 1
        if d.ndim != 1:
            raise ValueError(f"doc {i} must be 1-D, got shape {d.shape}")
        lengths.append(len(d))
    count("repro_torch.index.docs_converted", converted)
    return parts, np.array(lengths, np.int64)


def stage_docs(docs, device="cuda") -> tuple[torch.Tensor, np.ndarray, int]:
    """The sentinel-separator corpus layout (`encode_docs`) made on
    `device`: returns (text int64[N] on `device`, doc_starts int64[n_docs],
    n_docs).

    The host measures the documents and copies them back to back into one
    buffer, pinned when `device` is a CUDA device (PyTorch's caching host
    allocator hands the same block to the next corpus of that size); one
    copy takes it and the documents' ends to the device, where
    `ops.encode_place` shifts the data and places the separators in one
    pass and flags a negative token. Only then does the host look for the
    document that holds it."""
    device = resolve_device(device)
    n_docs = len(docs)
    if n_docs == 0:
        return (torch.zeros(0, dtype=torch.int64, device=device),
                np.zeros(0, np.int64), 0)
    pin = device.type == "cuda"
    with span("repro_torch.index.encode_docs"):
        parts, lengths = _doc_parts(docs)
        ends = torch.empty(n_docs, dtype=torch.int64, pin_memory=pin)
        np.cumsum(lengths, out=ends.numpy())
        flat = torch.empty(int(ends[-1]), dtype=torch.int64, pin_memory=pin)
        np.concatenate(parts, out=flat.numpy(), casting="unsafe")
    with span("repro_torch.index.upload"):
        text, negative = ops.encode_place(flat.to(device, non_blocking=True),
                                          ends.to(device, non_blocking=True))
        if negative.item():
            j = int(np.argmax(flat.numpy() < 0))
            doc = int(np.searchsorted(ends.numpy(), j, "right"))
            raise ValueError(f"doc {doc} has negative values")
    return text, ends.numpy() - lengths + np.arange(n_docs), n_docs


def encode_docs(docs) -> tuple[np.ndarray, np.ndarray, int]:
    """Sentinel-separator corpus layout: data values are shifted up by
    n_docs and doc i is terminated by separator value i. Separators are
    (a) unique, so no suffix comparison crosses a document boundary, and
    (b) below the data alphabet, so separator suffixes cluster at the front
    of the SA.

    Returns (text int64[N], doc_starts int64[n_docs], n_docs), on the host
    (`stage_docs` on the CPU).
    """
    text, starts, n_docs = stage_docs(docs, "cpu")
    return text.numpy(), starts, n_docs


@dataclass(frozen=True)
class NgramStats:
    """k-gram statistics over the indexed corpus (separator-free windows)."""

    k: int
    total: int        # number of k-gram positions fully inside one document
    distinct: int     # number of distinct k-gram strings among those


class SuffixArrayIndex:
    """Queryable suffix-array index over one document or a corpus.

    Positions returned by `locate` / `duplicate_spans` are offsets into the
    *encoded* text (`self.text`); for a single-document index these equal
    raw text offsets. `doc_of` / `doc_offset` map a position into
    (document, in-document offset).
    """

    def __init__(self, text, sa, *, doc_starts=None, shift: int = 0,
                 options: SAOptions | None = None, lcp=None,
                 sigma: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.text = torch.as_tensor(text).to(self.device, torch.int64)
        self.sa = torch.as_tensor(sa).to(self.device, torch.int32)
        self._check_shapes()
        n = len(self.text)
        self.doc_starts = (np.asarray(doc_starts, np.int64)
                           if doc_starts is not None
                           else np.zeros(1 if n else 0, np.int64))
        self.shift = int(shift)
        self.options = options if options is not None else SAOptions()
        self._lcp = None if lcp is None else np.asarray(lcp, np.int64)
        self._sigma = None if sigma is None else int(sigma)
        self._device_bufs = None     # lazy (text int32, sa int64) for queries
        self._host = None            # lazy numpy (text, sa) for LCP methods

    def _check_shapes(self) -> None:
        """Text-vs-SA shape contract; `repro_torch.sparse` relaxes it to
        ceil(n / s)."""
        if self.sa.shape != self.text.shape:
            raise ValueError(f"sa shape {tuple(self.sa.shape)} != text shape "
                             f"{tuple(self.text.shape)}")

    #: shortest pattern this index answers exactly; 0 = no restriction.
    #: `repro_torch.sparse.SparseSuffixArrayIndex` overrides it with its
    #: rate, and `longest_match_len` floors its probes at it.
    min_pattern_len = 0

    # ----------------------------------------------------------- construct
    @classmethod
    def build(cls, text, options: SAOptions | None = None, *,
              sigma: int | None = None, device="cuda",
              **overrides) -> "SuffixArrayIndex":
        """Index a single document (no separators, positions = raw
        offsets). Pass ``sigma=`` to declare the alphabet size (pattern
        validation otherwise infers it from the text's maximum value)."""
        opts = options if options is not None else SAOptions()
        if overrides:
            opts = opts.replace(**overrides)
        if opts.sample_rate > 1 and cls is SuffixArrayIndex:
            # facade dispatch: a sampled plan builds the sparse subclass
            from ..sparse import SparseSuffixArrayIndex
            return SparseSuffixArrayIndex.build(text, opts, sigma=sigma,
                                                device=device)
        with span("repro_torch.index.upload"):
            text = torch.as_tensor(np.asarray(text, np.int64),
                                   device=resolve_device(device))
        sa = build_suffix_array(text, opts, device=device)
        return cls(text, sa, shift=0, options=opts, sigma=sigma,
                   device=device)

    @classmethod
    def from_docs(cls, docs, options: SAOptions | None = None, *,
                  sigma: int | None = None, device="cuda",
                  **overrides) -> "SuffixArrayIndex":
        """Index a list of documents with the sentinel-separator layout."""
        opts = options if options is not None else SAOptions()
        if overrides:
            opts = opts.replace(**overrides)
        if opts.sample_rate > 1 and cls is SuffixArrayIndex:
            from ..sparse import SparseSuffixArrayIndex
            return SparseSuffixArrayIndex.from_docs(docs, opts, sigma=sigma,
                                                    device=device)
        text, starts, n_docs = stage_docs(docs, device)
        sa = build_suffix_array(text, opts, device=device)
        return cls(text, sa, doc_starts=starts, shift=n_docs, options=opts,
                   sigma=sigma, device=device)

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        """Persist this index under `path` (`repro_torch.api.store
        .save_index`); an index saved here loads in `repro` and back."""
        from .store import save_index
        return save_index(path, self)

    @classmethod
    def load(cls, path: str, *, options: SAOptions | None = None,
             device="cuda") -> "SuffixArrayIndex":
        """Restore an index persisted by `save` (or by `repro`) onto
        `device` (`repro_torch.api.store.load_index`)."""
        from .store import load_index
        return load_index(path, options=options, device=device)

    # ----------------------------------------------------------- structure
    @property
    def n(self) -> int:
        return len(self.text)

    @property
    def n_docs(self) -> int:
        return len(self.doc_starts)

    @property
    def sep_count(self) -> int:
        return self.shift          # one separator per document when encoded

    @property
    def sigma(self) -> int:
        """Data-alphabet size: patterns must use values in [0, sigma).

        Inferred as ``max data value + 1`` unless declared at construction
        (``sigma=``); 0 for an index with no data characters."""
        if self._sigma is None:
            data_max = int(self.text.max()) - self.shift if self.n else -1
            self._sigma = max(data_max + 1, 0)
        return self._sigma

    def _host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies (text int64, sa int32) for the numpy LCP methods."""
        if self._host is None:
            self._host = (self.text.cpu().numpy(), self.sa.cpu().numpy())
        return self._host

    @property
    def lcp(self) -> np.ndarray:
        """LCP array (Kasai), computed on first access and cached."""
        if self._lcp is None:
            self._lcp = lcp_kasai(*self._host_arrays())
        return self._lcp

    @property
    def _doc_ends(self) -> np.ndarray:
        """End (exclusive, separator position) of each document's payload."""
        if self.shift == 0:
            return np.full(self.n_docs, self.n, np.int64)
        return torch.nonzero(self.text < self.shift).flatten().cpu().numpy()

    def doc_of(self, pos):
        """Document index owning encoded position(s) `pos` (scalar or
        array). Positions must lie in [0, n); out-of-range values raise
        IndexError. An empty position array maps to an empty result."""
        pos_arr = np.asarray(pos)
        if pos_arr.size and (np.any(pos_arr < 0) or np.any(pos_arr >= self.n)):
            raise IndexError(
                f"position(s) out of range for index of length {self.n}")
        idx = np.searchsorted(self.doc_starts, pos_arr, side="right") - 1
        if np.isscalar(pos) or np.ndim(pos) == 0:
            return int(idx)
        return idx.astype(np.int64)

    def doc_offset(self, pos):
        """(doc, in-document offset) for encoded position(s) `pos`."""
        doc = self.doc_of(pos)
        return doc, np.asarray(pos) - self.doc_starts[doc]

    # ------------------------------------------------------------- queries
    def _encode_pattern(self, pattern) -> np.ndarray:
        """Validate + shift a raw pattern into the encoded alphabet.

        Values must lie in ``[0, sigma)``: negatives always raise, and
        values ≥ sigma raise too (they can never occur in the data). The
        alphabet check is skipped on an empty index (every count is 0).
        """
        pat = np.asarray(pattern, np.int64).ravel()
        if len(pat):
            if int(pat.min()) < 0:
                raise ValueError("pattern values must be ≥ 0")
            if self.n and int(pat.max()) >= self.sigma:
                raise ValueError(
                    f"pattern value {int(pat.max())} outside the index "
                    f"alphabet [0, {self.sigma}) — out-of-alphabet queries "
                    f"are rejected rather than silently counted as 0")
        return pat + self.shift

    def _device_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(text int32, sa int64) buffers for the batched search, created on
        first use and cached for the life of the index."""
        if self._device_bufs is None:
            if self.n and int(self.text.max()) >= INT32_MAX:
                raise NotImplementedError(
                    "batched queries need int32-representable symbols "
                    f"(max encoded value {int(self.text.max())})")
            self._device_bufs = (self.text.to(torch.int32),
                                 self.sa.to(torch.int64))
        return self._device_bufs

    def _suffix_cmp(self, starts: np.ndarray, pat: np.ndarray) -> np.ndarray:
        """Vectorised 3-way prefix compare of suffixes at `starts` vs `pat`:
        -1 suffix < pat, 0 pat is a prefix of suffix, +1 suffix > pat.
        One numpy gather + compare per call, over `_host_arrays`."""
        starts = np.asarray(starts, np.int64).ravel()
        m, n = len(pat), self.n
        if m == 0 or n == 0:
            # empty pattern is a prefix of everything; on an empty index
            # every probe is past-the-end, i.e. "suffix < pat". Guarded
            # here so n-1 == -1 can never wrap the gather below.
            return np.full(len(starts), -1 if (n == 0 and m) else 0, np.int8)
        text = self._host_arrays()[0]
        idx = starts[:, None] + np.arange(m, dtype=np.int64)[None, :]
        in_range = idx < n
        seg = np.where(in_range, text[np.minimum(idx, n - 1)],
                       np.int64(-1))       # past-the-end < every real char
        diff = seg != pat[None, :]
        any_diff = diff.any(axis=1)
        first = np.where(any_diff, diff.argmax(axis=1), 0)
        rows = np.arange(len(starts))
        out = np.zeros(len(starts), np.int8)
        s_at, p_at = seg[rows, first], pat[first]
        out[any_diff & (s_at < p_at)] = -1
        out[any_diff & (s_at > p_at)] = 1
        return out

    def _sa_range(self, pat: np.ndarray) -> tuple[int, int]:
        """[lo, hi) block of SA ranks whose suffixes start with `pat` (an
        encoded pattern, `_encode_pattern`).

        The scalar reference search of the JAX package: a Python
        binary-search loop where every probe is one vectorised
        `_suffix_cmp` call, O(|pat| log n) numpy work per pattern on the
        host. Nothing serves through it; it is the oracle that
        `sa_ranges_batch` is held to."""
        sa = self._host_arrays()[1]
        n = len(sa)
        if len(pat) == 0:
            return 0, n
        lo = np.zeros(2, np.int64)
        hi = np.full(2, n, np.int64)
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) // 2
            c = self._suffix_cmp(sa[np.where(active, mid, 0)], pat)
            # bound 0 = first suffix ≥ pat, bound 1 = first suffix > pat
            before = np.array([c[0] < 0, c[1] <= 0])
            lo = np.where(active & before, mid + 1, lo)
            hi = np.where(active & ~before, mid, hi)
        return int(lo[0]), int(lo[1])

    def _as_batch(self, patterns) -> QueryBatch:
        return (patterns if isinstance(patterns, QueryBatch)
                else QueryBatch.encode(self, patterns))

    def sa_ranges_batch(self, patterns) -> tuple[np.ndarray, np.ndarray]:
        """`[lo, hi)` SA-rank ranges for many patterns in one search.

        `patterns` is a sequence of int sequences (mixed lengths fine) or a
        pre-encoded `QueryBatch`. Returns two int64 arrays of length
        `len(patterns)`. Empty patterns resolve to (0, n); patterns longer
        than the text to an empty range."""
        return batch_ranges(self, self._as_batch(patterns))

    def count_batch(self, patterns) -> np.ndarray:
        """Occurrence counts for many patterns — int64[len(patterns)]. The
        empty pattern is a prefix of every suffix, so it counts n."""
        lo, hi = self.sa_ranges_batch(patterns)
        return hi - lo

    def contains_batch(self, patterns) -> np.ndarray:
        """Presence flags for many patterns — bool[len(patterns)]."""
        return self.count_batch(patterns) > 0

    def locate_batch(self, patterns) -> list:
        """Sorted encoded start positions per pattern — a list of int64
        arrays. Raises `ValueError` on an empty pattern (its result is
        every position; enumerate that with `numpy.arange(n)`)."""
        qb = self._as_batch(patterns)
        if self.n and np.any(qb.lens[:qb.n_queries] == 0):
            raise ValueError("locate of an empty pattern is every position "
                             "in the index; use numpy.arange(n) instead")
        lo, hi = batch_ranges(self, qb)
        return self._positions(lo, hi)

    def _positions(self, lo: np.ndarray, hi: np.ndarray) -> list:
        """Sorted SA entries of each [lo, hi) range: one gather and one
        segmented sort on the device, one copy back."""
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return [np.zeros(0, np.int64) for _ in counts]
        _, sa_d = self._device_state()
        dev = self.device
        counts_d = torch.from_numpy(counts).to(dev)
        seg = torch.repeat_interleave(
            torch.arange(len(counts), device=dev), counts_d,
            output_size=total)
        first = torch.from_numpy(lo - (np.cumsum(counts) - counts)).to(dev)
        pos = sa_d[first[seg] + torch.arange(total, device=dev)]
        keyed = torch.sort((seg << 32) | pos).values & INT32_MAX
        return np.split(keyed.cpu().numpy(), np.cumsum(counts)[:-1])

    def locate_docs_batch(self, patterns) -> list:
        """Occurrences in **document coordinates**: one int64[k, 2] array of
        (doc, in-doc offset) rows per pattern, sorted lexicographically."""
        out = []
        for pos in self.locate_batch(patterns):
            doc, off = self.doc_offset(pos)
            out.append(np.stack([np.asarray(doc, np.int64).ravel(),
                                 np.asarray(off, np.int64).ravel()], axis=1)
                       if len(pos) else np.zeros((0, 2), np.int64))
        return out

    # --------------------------------------------------- encoded fan-in API
    def _counts_encoded(self, enc) -> np.ndarray:
        """Counts for already-encoded patterns (`_encode_pattern` output):
        the per-segment primitive a `SegmentedIndex` fans out over, for
        dense and sparse segments alike."""
        return self.count_batch(QueryBatch.from_encoded(self, enc))

    def _positions_encoded(self, enc) -> list:
        """Sorted encoded positions per already-encoded pattern."""
        return self.locate_batch(QueryBatch.from_encoded(self, enc))

    # ------------------------------------------------- serving-tier protocol
    def stage_encoded(self, enc):
        """Package already-encoded patterns for the serving tier and begin
        their host→device copy (`stage_batch`). Returns an opaque work
        item for `ranges_staged`; `repro_torch.serve.SAServer` stages on
        one thread and resolves on another."""
        batch = QueryBatch.from_encoded(self, enc)
        return (batch, stage_batch(self, batch) if self.n else None)

    def ranges_staged(self, work) -> tuple[np.ndarray, np.ndarray]:
        """Resolve a `stage_encoded` work item to its (lo, hi) SA ranges."""
        batch, staged = work
        return batch_ranges(self, batch, staged=staged)

    # ----------------------------------------------------- scalar shims
    def count(self, pattern) -> int:
        """Occurrences of `pattern` across the corpus (a batch of one);
        `count([]) == n`."""
        return int(self.count_batch([pattern])[0])

    def locate(self, pattern) -> np.ndarray:
        """Sorted encoded start positions of every occurrence of `pattern`
        (a batch of one)."""
        return self.locate_batch([pattern])[0]

    def locate_docs(self, pattern) -> np.ndarray:
        """Occurrences as an int64[k, 2] array of (doc, in-doc offset)."""
        pos = self.locate(pattern)
        doc, off = self.doc_offset(pos)
        return np.stack([np.asarray(doc, np.int64), off], axis=1)

    def longest_match(self, seq) -> int:
        """Longest substring of ``seq`` occurring anywhere in the index
        (`longest_match_len`)."""
        return longest_match_len(self, seq)

    # ---------------------------------------------------------- statistics
    def ngram_stats(self, k: int) -> NgramStats:
        """Total / distinct k-grams, counting only windows that lie fully
        inside one document (never spanning a separator)."""
        if k <= 0 or self.n == 0:
            return NgramStats(k=k, total=0, distinct=0)
        pos = self._host_arrays()[1].astype(np.int64)
        if self.shift == 0:
            valid = pos + k <= self.n
        else:
            ends = self._doc_ends
            owner = np.searchsorted(self.doc_starts, pos, side="right") - 1
            valid = pos + k <= ends[owner]
        distinct = int(np.sum(valid & (self.lcp < k)))
        return NgramStats(k=k, total=int(np.sum(valid)), distinct=distinct)

    def duplicate_spans(self, min_len: int) -> list:
        """Merged (start, end) spans covered by a substring of length ≥
        min_len occurring at least twice (Lee et al. dedup criterion)."""
        text, sa = self._host_arrays()
        return repeated_substring_spans(text, sa, self.lcp, min_len)

    def cross_doc_duplicates(self, min_len: int) -> list:
        """(doc_i, doc_j, length) for SA-adjacent repeats ≥ min_len spanning
        two DIFFERENT documents."""
        lcp = self.lcp
        r = np.flatnonzero(lcp >= min_len)
        r = r[r >= 1]
        if len(r) == 0:
            return []
        sa = self._host_arrays()[1]
        a = sa[r - 1].astype(np.int64)
        b = sa[r].astype(np.int64)
        da = np.searchsorted(self.doc_starts, a, side="right") - 1
        db = np.searchsorted(self.doc_starts, b, side="right") - 1
        hit = da != db
        lo = np.minimum(da, db)[hit]
        hi = np.maximum(da, db)[hit]
        ln = lcp[r][hit]
        return [(int(i), int(j), int(l)) for i, j, l in zip(lo, hi, ln)]

    def __repr__(self) -> str:
        return (f"SuffixArrayIndex(n={self.n}, n_docs={self.n_docs}, "
                f"device={self.device}, "
                f"backend={self.options.resolve_backend()!r}, "
                f"lcp={'cached' if self._lcp is not None else 'lazy'})")


def index_from_numpy_state(state: Mapping, *, device="cuda",
                           options: SAOptions | None = None
                           ) -> SuffixArrayIndex:
    """Carry an index across: `state` holds ``text``, ``sa``,
    ``doc_starts`` (numpy arrays) and ``shift``, ``sigma`` (ints) — the
    arrays of a `repro.api.SuffixArrayIndex`, say. Returns the port's index
    with text and SA on `device`; no suffix array is rebuilt."""
    return SuffixArrayIndex(
        np.asarray(state["text"], np.int64), np.asarray(state["sa"]),
        doc_starts=state["doc_starts"], shift=int(state["shift"]),
        sigma=int(state["sigma"]), options=options, device=device)
