"""`SegmentedIndex` — incremental multi-segment serving over many docs.

The port of `repro.api.segments`. The corpus is a set of **segments**,
each an independent port index (`SuffixArrayIndex`, or the sparse one
when ``options.sample_rate > 1``) over a slice of the documents, all on
one device:

* **ingest** (`add_docs`) builds one small segment over just the new
  documents — builder traffic is O(new docs), not O(corpus);
* **delete** (`delete_doc`) rebuilds only the segment that owned the
  document;
* **queries** fan a pattern batch across segments (one batched search per
  segment) and merge: counts add, located positions map through each
  segment's doc table back to *global* document coordinates;
* a **size-tiered compaction** policy (`compact`) merges segments whose
  sizes share a tier once `compact_fanin` of them pile up, so per-query
  fan-out stays O(log_fanin(corpus / ingest)).

A segmented index has no global encoded text, so `locate_batch` returns
**(doc, offset)** rows (int64[k, 2], sorted lexicographically), the
representation of `SuffixArrayIndex.locate_docs_batch` for a monolithic
index over the same documents. Every segment build goes through
`_new_segment`, so the `repro_torch.trace` counter ``repro_torch.builds``
counts segment builds exactly (dense plans; the sparse build does not go
through `build_suffix_array`).

Persistence lives in `repro_torch.api.store.SegmentedIndexStore`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.compat import resolve_device
from .index import SuffixArrayIndex, longest_match_len
from .options import SAOptions

__all__ = ["Segment", "SegmentedIndex"]


@dataclass
class Segment:
    """One independently-built slice of the corpus.

    `doc_ids[j]` is the *global* document id of the segment's local
    document j — the only state needed to merge per-segment query results
    back into corpus coordinates.
    """

    seg_id: str
    doc_ids: np.ndarray                  # int64[local n_docs], global ids
    index: SuffixArrayIndex
    version: int = 0                     # checkpoint step on disk

    def __post_init__(self):
        self.doc_ids = np.asarray(self.doc_ids, np.int64)
        if len(self.doc_ids) != self.index.n_docs:
            raise ValueError(
                f"segment {self.seg_id!r} maps {len(self.doc_ids)} doc ids "
                f"onto an index of {self.index.n_docs} docs")

    @property
    def n(self) -> int:
        return self.index.n

    def payloads(self) -> list[np.ndarray]:
        """Decode the segment's raw documents back out of the encoded text
        (payload = chars between doc start and separator, unshifted).
        Exact inverse of `encode_docs` — rebuilds and merges never need
        the original inputs kept around."""
        idx = self.index
        starts, ends = idx.doc_starts, idx._doc_ends
        text = idx.text.cpu().numpy()
        return [text[s:e] - idx.shift for s, e in zip(starts, ends)]

    def __repr__(self) -> str:
        return (f"Segment(id={self.seg_id!r}, docs={len(self.doc_ids)}, "
                f"n={self.n}, v{self.version})")


def _tier_of(n: int, fanin: int) -> int:
    """Size tier of a segment with n encoded chars: segments land in the
    same tier iff their sizes are within one power of `fanin`."""
    t = 0
    n = max(int(n), 1)
    while n >= fanin:
        n //= fanin
        t += 1
    return t


class SegmentedIndex:
    """Multi-segment corpus index with incremental ingest/delete.

    Query surface mirrors `SuffixArrayIndex` where the semantics carry
    over (`count` / `count_batch` / `contains_batch` / empty pattern
    counts `n`), and diverges where a global encoded text does not exist:
    `locate_batch` / `locate` return (doc, offset) rows — see the module
    docstring. The serving tier (`repro_torch.serve.SAServer`,
    `repro_torch.api.QuerySession`) accepts either index kind through the
    shared `_encode_pattern` / `stage_encoded` / `ranges_staged`
    protocol. Every segment lives on `device`.
    """

    def __init__(self, segments=(), *, options: SAOptions | None = None,
                 sigma: int | None = None, next_doc_id: int | None = None,
                 next_seg: int = 0, compact_fanin: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._segments: list[Segment] = list(segments)
        for seg in self._segments:
            if seg.index.device != self.device:
                raise ValueError(f"segment {seg.seg_id!r} lives on "
                                 f"{seg.index.device}, not {self.device}")
        self.options = options if options is not None else SAOptions()
        self._sigma = None if sigma is None else int(sigma)
        fanin = (compact_fanin if compact_fanin is not None
                 else self.options.compact_fanin)
        if fanin < 2:
            raise ValueError(f"compact_fanin must be ≥ 2, got {fanin}")
        self.compact_fanin = int(fanin)
        top = max((int(s.doc_ids.max()) + 1 for s in self._segments
                   if len(s.doc_ids)), default=0)
        self._next_doc_id = (int(next_doc_id) if next_doc_id is not None
                             else top)
        if self._next_doc_id < top:
            raise ValueError(f"next_doc_id {next_doc_id} collides with "
                             f"existing doc id {top - 1}")
        self._next_seg = int(next_seg)
        # seg ids written since the last store sync / dropped and not yet
        # garbage-collected on disk (repro_torch.api.store
        # .SegmentedIndexStore)
        self.dirty: set[str] = {s.seg_id for s in self._segments}
        self.dropped: set[str] = set()

    # ----------------------------------------------------------- construct
    @classmethod
    def from_docs(cls, docs, options: SAOptions | None = None, *,
                  sigma: int | None = None, segment_docs: int | None = None,
                  device="cuda", **overrides) -> "SegmentedIndex":
        """Build a segmented index over `docs`, `segment_docs` documents
        per segment (default `options.segment_docs`, else one segment —
        the monolithic layout, still servable through the same surface).
        Document i gets global doc id i, exactly like the monolithic
        `SuffixArrayIndex.from_docs` numbering.

        The requested layout is produced EXACTLY — no compaction runs
        here, so tests can pin per-segment structure. Compaction kicks in
        on `add_docs` / `delete_doc`, or call `compact()` yourself."""
        opts = options if options is not None else SAOptions()
        if overrides:
            opts = opts.replace(**overrides)
        per = segment_docs if segment_docs is not None else opts.segment_docs
        if per is not None and int(per) < 1:
            raise ValueError(f"segment_docs must be ≥ 1, got {per}")
        per = int(per) if per else max(len(docs), 1)
        self = cls(options=opts, sigma=sigma, device=device)
        for at in range(0, len(docs), per):
            self._new_segment(list(docs[at:at + per]),
                              np.arange(at, min(at + per, len(docs)),
                                        dtype=np.int64))
        self._next_doc_id = len(docs)
        return self

    def _new_segment(self, payloads, doc_ids) -> Segment:
        """Build ONE segment over `payloads` — this is the only place
        segment construction happens, so the ``repro_torch.builds``
        counter counts segment builds exactly (the ingest-amortization
        metric). The
        facade dispatch in `SuffixArrayIndex.from_docs` makes segments
        sparse automatically when `options.sample_rate > 1`."""
        index = SuffixArrayIndex.from_docs(payloads, self.options,
                                           sigma=self._sigma,
                                           device=self.device)
        seg = Segment(seg_id=f"seg-{self._next_seg:06d}",
                      doc_ids=np.asarray(doc_ids, np.int64), index=index)
        self._next_seg += 1
        self._segments.append(seg)
        self.dirty.add(seg.seg_id)
        return seg

    def _drop_segment(self, seg: Segment) -> None:
        self._segments.remove(seg)
        self.dirty.discard(seg.seg_id)
        self.dropped.add(seg.seg_id)

    # ----------------------------------------------------------- structure
    @property
    def segments(self) -> tuple[Segment, ...]:
        return tuple(self._segments)

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    @property
    def n(self) -> int:
        """Total encoded chars across segments (equals the monolithic n —
        one separator per document either way)."""
        return sum(s.n for s in self._segments)

    @property
    def n_docs(self) -> int:
        return sum(len(s.doc_ids) for s in self._segments)

    @property
    def doc_ids(self) -> np.ndarray:
        """Every live global doc id, sorted."""
        parts = [s.doc_ids for s in self._segments]
        return (np.sort(np.concatenate(parts)) if parts
                else np.zeros(0, np.int64))

    @property
    def sigma(self) -> int:
        """Global data alphabet: declared, else the max over segments."""
        if self._sigma is not None:
            return self._sigma
        return max((s.index.sigma for s in self._segments), default=0)

    def doc(self, doc_id: int) -> np.ndarray:
        """Raw payload of global document `doc_id` (decoded, unshifted)."""
        seg, local = self._find_doc(doc_id)
        return seg.payloads()[local]

    def _find_doc(self, doc_id: int) -> tuple[Segment, int]:
        for seg in self._segments:
            hit = np.flatnonzero(seg.doc_ids == int(doc_id))
            if len(hit):
                return seg, int(hit[0])
        raise KeyError(f"no document with id {doc_id}")

    # ------------------------------------------------------------- queries
    @property
    def min_pattern_len(self) -> int:
        """Shortest pattern this corpus answers exactly — the per-segment
        sparse rate when `options.sample_rate > 1`, else 0 (no floor)."""
        return self.options.sample_rate if self.options.sample_rate > 1 else 0

    def _encode_pattern(self, pattern) -> np.ndarray:
        """Validate a raw pattern against the *global* alphabet.

        Unlike `SuffixArrayIndex._encode_pattern` the result is NOT
        shifted — each segment has its own separator shift, applied at
        fan-out time. Same strictness rules: values must lie in
        [0, sigma), checked only when the corpus is non-empty; in sparse
        mode (`options.sample_rate > 1`) patterns shorter than the rate
        raise `repro_torch.sparse.PatternTooShortError` here, before any
        segment fan-out."""
        pat = np.asarray(pattern, np.int64).ravel()
        if len(pat):
            if int(pat.min()) < 0:
                raise ValueError("pattern values must be ≥ 0")
            if self.n and int(pat.max()) >= self.sigma:
                raise ValueError(
                    f"pattern value {int(pat.max())} outside the corpus "
                    f"alphabet [0, {self.sigma}) — out-of-alphabet queries "
                    f"are rejected rather than silently counted as 0")
        if len(pat) < self.min_pattern_len:
            from ..sparse import PatternTooShortError
            raise PatternTooShortError(len(pat), self.options.sample_rate)
        return pat

    def _fan_encoded(self, enc) -> list[tuple[Segment, list]]:
        """Per-segment shift application for a list of *raw* (unshifted)
        validated patterns; empty segments are skipped. Pattern values
        past a segment's own data maximum simply never match — the
        separator band is below `seg.index.shift`, so a shifted pattern
        can never alias it."""
        return [(seg, [np.asarray(e, np.int64) + seg.index.shift
                       for e in enc])
                for seg in self._segments if seg.index.n]

    def count_batch(self, patterns) -> np.ndarray:
        """Merged occurrence counts — each segment resolves the batch
        through its own engine (`_counts_encoded`: SA range widths dense,
        the two-level verified plan sparse) and counts add;
        int64[len(patterns)]. The empty pattern counts the total encoded
        length `n`, exactly as monolithic (dense mode only — sparse mode
        rejects it as too short)."""
        enc = [self._encode_pattern(p) for p in patterns]
        counts = np.zeros(len(enc), np.int64)
        for seg, shifted in self._fan_encoded(enc):
            counts += seg.index._counts_encoded(shifted)
        return counts

    def contains_batch(self, patterns) -> np.ndarray:
        return self.count_batch(patterns) > 0

    def locate_batch(self, patterns) -> list:
        """Occurrences in **global document coordinates**: one
        int64[k, 2] array of (doc_id, in-doc offset) rows per pattern,
        sorted lexicographically. A segmented corpus has no global
        encoded text, so there is no encoded-position result to return —
        compare against `SuffixArrayIndex.locate_docs_batch`, which is
        byte-identical for the same documents. Raises `ValueError` on an
        empty pattern (same rule as monolithic locate)."""
        enc = [self._encode_pattern(p) for p in patterns]
        if self.n and any(len(e) == 0 for e in enc):
            raise ValueError("locate of an empty pattern is every position "
                             "in the corpus; enumerate documents instead")
        per: list[list] = [[] for _ in enc]
        for seg, shifted in self._fan_encoded(enc):
            for qi, pos in enumerate(seg.index._positions_encoded(shifted)):
                if len(pos):
                    local, off = seg.index.doc_offset(pos)
                    per[qi].append(np.stack(
                        [seg.doc_ids[local], off], axis=1))
        out = []
        for rows in per:
            if not rows:
                out.append(np.zeros((0, 2), np.int64))
                continue
            allrows = np.concatenate(rows)
            order = np.lexsort((allrows[:, 1], allrows[:, 0]))
            out.append(allrows[order])
        return out

    locate_docs_batch = locate_batch   # monolithic-compatible spelling

    def count(self, pattern) -> int:
        return int(self.count_batch([pattern])[0])

    def contains(self, pattern) -> bool:
        return bool(self.contains_batch([pattern])[0])

    def locate(self, pattern) -> np.ndarray:
        """(doc_id, offset) rows for one pattern — see `locate_batch`."""
        return self.locate_batch([pattern])[0]

    locate_docs = locate               # monolithic-compatible spelling

    def longest_match(self, seq) -> int:
        """Longest substring of ``seq`` occurring anywhere in the corpus —
        same semantics as `SuffixArrayIndex.longest_match`, resolved
        through the per-segment fan-out (each containment probe is one
        merged `contains_batch`)."""
        return longest_match_len(self, seq)

    # ------------------------------------------------- serving-tier protocol
    def stage_encoded(self, enc):
        """Serving-tier staging (`repro_torch.serve.SAServer`): begin the
        host→device copy of one per-segment `QueryBatch` per non-empty
        segment, the monolithic `SuffixArrayIndex.stage_encoded` contract."""
        return (len(enc), [(seg, seg.index.stage_encoded(shifted))
                           for seg, shifted in self._fan_encoded(enc)])

    def ranges_staged(self, work):
        """Execute staged per-segment work items and merge. Returns
        ``(lo, hi)`` where ``lo`` is all-zero and ``hi`` the merged count
        per pattern — the *virtual* merged range [0, count): per-segment
        SA ranks don't compose into global ranks, so only the width
        survives the merge. Delegating to
        each segment's own `ranges_staged` keeps the fan-out uniform
        across dense and sparse segments — both report exact widths."""
        k, works = work
        counts = np.zeros(k, np.int64)
        for seg, w in works:
            lo, hi = seg.index.ranges_staged(w)
            counts += hi - lo
        return np.zeros(k, np.int64), counts

    # -------------------------------------------------------------- ingest
    def add_docs(self, docs, *, compact: bool = True) -> list[int]:
        """Ingest `docs` as ONE new segment; returns their global doc ids.

        Exactly one segment build per call (asserted via the
        ``repro_torch.builds`` counter); with
        ``compact=True`` (default)
        size-tiered compaction then runs and may additionally merge —
        amortised, that keeps total builder traffic
        O(ingest · log_fanin n) while bounding query fan-out. Pass
        ``compact=False`` to defer merging (e.g. batch-ingest loops that
        compact once at the end). An empty `docs` is a no-op."""
        docs = list(docs)
        if not docs:
            return []
        ids = np.arange(self._next_doc_id, self._next_doc_id + len(docs),
                        dtype=np.int64)
        self._next_doc_id += len(docs)
        self._new_segment(docs, ids)
        if compact:
            self.compact()
        return ids.tolist()

    def delete_doc(self, doc_id: int, *, compact: bool = True) -> None:
        """Remove one document, rebuilding ONLY its owning segment (zero
        builds when the segment becomes empty — it is simply dropped)."""
        seg, local = self._find_doc(doc_id)
        payloads = seg.payloads()
        keep = [p for j, p in enumerate(payloads) if j != local]
        keep_ids = np.delete(seg.doc_ids, local)
        self._drop_segment(seg)
        if keep:
            self._new_segment(keep, keep_ids)
        if compact:
            self.compact()

    def compact(self) -> int:
        """Size-tiered compaction: whenever `compact_fanin` segments share
        a size tier (sizes within one power of `compact_fanin`), merge
        them into one. Repeats until no tier overflows — merged segments
        promote to higher tiers, so fan-out is bounded by
        O(fanin · log_fanin n). Returns the number of merges performed."""
        merges = 0
        while True:
            tiers: dict[int, list[Segment]] = {}
            for seg in self._segments:
                tiers.setdefault(_tier_of(seg.n, self.compact_fanin),
                                 []).append(seg)
            full = sorted(t for t, ss in tiers.items()
                          if len(ss) >= self.compact_fanin)
            if not full:
                return merges
            victims = tiers[full[0]]
            payloads: list[np.ndarray] = []
            ids: list[np.ndarray] = []
            for seg in victims:
                payloads.extend(seg.payloads())
                ids.append(seg.doc_ids)
                self._drop_segment(seg)
            self._new_segment(payloads, np.concatenate(ids))
            merges += 1

    def __repr__(self) -> str:
        return (f"SegmentedIndex(segments={self.n_segments}, "
                f"docs={self.n_docs}, n={self.n}, "
                f"fanin={self.compact_fanin})")
