"""SA-backed training data plane: streaming shard dedup, train/eval
contamination gate, memorization probe, deterministic batching.

The port of `repro.data.pipeline`. Every index of the plane lives on one
device (``device="cuda"`` unless the caller asks for ``"cpu"``): the
training `repro_torch.api.SegmentedIndex`, whose segment builds run the
radix window sort on the card, and the gate's eval index. The filters'
bookkeeping (gram sets, drop masks, batches) stays numpy on the host, and
batches are numpy, byte-identical to `repro`'s for the same seed:

    shards ──▶ StreamingDedup ──▶ packed corpus ──▶ batch_at(step)
                  │    │                                 │
                  │    └─ ingest: ONE segment build      ├─ ContaminationGate
                  ▼       per shard (SegmentedIndex)     │  (eval index,
            training index ◀── MemorizationProbe ◀───────┘   reject | mask)
                               (decoded samples)

* **StreamingDedup** — each document shard is ingested into the
  `SegmentedIndex` as exactly ONE new segment (builder-cache deltas are
  asserted in tests); the shard's own segment SA answers "earlier
  occurrence *within* this shard" and a batched containment query against
  the accumulated index answers "occurs in any *prior* shard". Because the
  gram drop rule is prefix-stable (`repro_torch.text.dedup`), the streamed
  output is **byte-identical** to the monolithic `dedup_docs`.
* **ContaminationGate** — a held-out eval set gets its own index; every
  candidate training window's ``gate_min_len``-grams go through chunked
  `count_batch` calls, and windows whose hit count exceeds the threshold
  are rejected (deterministically resampled) or loss-masked.
* **MemorizationProbe** — samples are scored for their longest verbatim
  copy out of the *training* index (`longest_match`).

`batch_at(step)` is a pure function of (seed, step) given the plane's
corpus and eval set — restoring step k replays exactly the batches ≥ k,
gate decisions included."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api import SAOptions, SegmentedIndex, SuffixArrayIndex
from ..core.compat import resolve_device
from ..text.dedup import (DEDUP_MIN_LEN, duplicate_gram_flags,
                          gram_drop_mask)
from ..trace import counters

GATE_POLICIES = ("reject", "mask")


def synthetic_corpus(n_chars: int, vocab: int = 256, *, dup_fraction:
                     float = 0.0, seed: int = 0) -> np.ndarray:
    """Zipf-ish random byte corpus; optionally inject duplicate blocks so the
    dedup stage has real work to do."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    x = rng.choice(vocab, size=n_chars, p=probs).astype(np.int32)
    if dup_fraction > 0:
        blk = max(64, n_chars // 50)
        n_dup = int(dup_fraction * n_chars / blk)
        for _ in range(n_dup):
            src = int(rng.integers(0, max(n_chars - blk, 1)))
            dst = int(rng.integers(0, max(n_chars - blk, 1)))
            x[dst:dst + blk] = x[src:src + blk]
    return x


def synthetic_doc_shards(n_chars: int, vocab: int = 256, *,
                         shard_docs: int = 8, doc_len: int = 2048,
                         dup_fraction: float = 0.0, seed: int = 0) -> list:
    """The streaming twin of `synthetic_corpus`: the same corpus chopped
    into documents of `doc_len` chars, grouped `shard_docs` documents per
    shard — the arrival unit of the data plane."""
    corpus = synthetic_corpus(n_chars, vocab, dup_fraction=dup_fraction,
                              seed=seed)
    docs = [corpus[at:at + doc_len] for at in range(0, len(corpus), doc_len)]
    return [docs[at:at + shard_docs]
            for at in range(0, len(docs), shard_docs)]


@dataclass
class PipelineConfig:
    """Knobs for the training data plane (and the legacy `TokenPipeline`).

    ``dedup_min_len`` defaults to the one pinned threshold
    (`repro_torch.text.dedup.DEDUP_MIN_LEN`); it used to disagree with
    `dedup_corpus`'s default (48 vs 32)."""

    seq_len: int = 512
    global_batch: int = 8
    dedup: bool = False
    dedup_min_len: int = DEDUP_MIN_LEN
    seed: int = 0
    # ---- data-plane stages ----
    options: SAOptions | None = None   # SA construction plan (None → auto)
    vocab: int | None = None           # declared alphabet for every index
    build_index: bool | None = None    # None → auto (dedup implies index)
    compact_every: int = 0             # compact() every k shards (0 = never;
                                       # merges add builder traffic on top of
                                       # the one-build-per-shard ingest)
    # ---- contamination gate (active when the plane gets eval docs) ----
    gate_min_len: int = DEDUP_MIN_LEN
    gate_policy: str = "reject"        # "reject" | "mask" (GATE_POLICIES)
    gate_max_hits: int = 0             # contaminated gram starts tolerated
    gate_max_resample: int = 8         # reject-policy redraw rounds before
                                       # falling back to masking the window
    # ---- memorization probe ----
    probe_min_len: int = DEDUP_MIN_LEN

    def __post_init__(self):
        if self.gate_policy not in GATE_POLICIES:
            raise ValueError(f"unknown gate_policy {self.gate_policy!r}; "
                             f"expected one of {GATE_POLICIES}")
        rate = self.options.sample_rate if self.options is not None else 1
        if rate > 1:
            # a sparse index answers exactly only for patterns ≥ its rate;
            # every gram the plane queries must clear that bar, so the
            # incompatibility is rejected at construction, not mid-stream
            if rate > self.dedup_min_len:
                raise ValueError(
                    f"options.sample_rate={rate} > dedup_min_len="
                    f"{self.dedup_min_len}: the sparse training index "
                    f"cannot answer the dedup stage's {self.dedup_min_len}-"
                    f"grams — lower sample_rate or raise dedup_min_len")
            if rate > self.gate_min_len:
                raise ValueError(
                    f"options.sample_rate={rate} > gate_min_len="
                    f"{self.gate_min_len}: the sparse eval index cannot "
                    f"answer the contamination gate's {self.gate_min_len}-"
                    f"grams — lower sample_rate or raise gate_min_len")

    @property
    def wants_index(self) -> bool:
        return self.dedup if self.build_index is None else self.build_index


@dataclass
class ShardStats:
    """What one shard cost as it moved through the plane."""

    docs: int = 0
    chars: int = 0
    kept_chars: int = 0
    dropped_chars: int = 0
    prior_hits: int = 0        # gram starts matched in earlier shards
    within_hits: int = 0       # gram starts matched earlier in this shard
    unique_grams: int = 0
    builds: int = 0            # builder-cache delta (ingest = exactly 1)


@dataclass
class PlaneReport:
    """Aggregate over every shard the plane has ingested. `dup_chars` /
    `dup_fraction` mirror the legacy `DedupReport` spelling (they count
    *dropped* chars — what the launcher prints as "removed")."""

    shards: int = 0
    docs: int = 0
    n_chars: int = 0
    kept_chars: int = 0
    dropped_chars: int = 0
    builds: int = 0

    @property
    def dup_chars(self) -> int:
        return self.dropped_chars

    @property
    def dup_fraction(self) -> float:
        return self.dropped_chars / max(self.n_chars, 1)

    def absorb(self, st: ShardStats) -> None:
        self.shards += 1
        self.docs += st.docs
        self.n_chars += st.chars
        self.kept_chars += st.kept_chars
        self.dropped_chars += st.dropped_chars
        self.builds += st.builds


def _builds() -> int:
    return counters().get("repro_torch.builds", 0)


def _doc_grams(doc: np.ndarray, g: int) -> np.ndarray:
    """[n_pos, g] sliding windows (empty when the doc is shorter than g)."""
    if len(doc) < g:
        return np.zeros((0, g), np.int64)
    return np.lib.stride_tricks.sliding_window_view(doc, g)


class StreamingDedup:
    """Per-shard exact-substring dedup against everything seen so far.

    Shares the drop rule with the monolithic
    `repro_torch.text.dedup.dedup_docs` — position p of a new document is
    flagged when its ``min_len``-gram occurred at any earlier global
    position. "Earlier" splits along the shard boundary:

    * **prior shards** — one batched containment query (`contains_batch`,
      chunked) against the accumulated `SegmentedIndex`, on the shard's
      *deduplicated set* of grams;
    * **within this shard** — the gram-run rule over the shard's own
      fresh segment SA (`duplicate_gram_flags`), which also covers
      earlier documents of the same shard.

    Ingest is exactly ONE segment build (`add_docs(compact=False)`); the
    raw (pre-drop) documents are what enters the index, because that is
    what the monolithic reference matches against.
    """

    def __init__(self, index: SegmentedIndex, min_len: int = DEDUP_MIN_LEN,
                 *, chunk: int = 2048):
        if min_len < 1:
            raise ValueError(f"min_len must be ≥ 1, got {min_len}")
        if index.options.sample_rate > min_len:
            raise ValueError(
                f"StreamingDedup over a sparse index needs min_len ≥ "
                f"sample_rate (exact containment of every {min_len}-gram); "
                f"got sample_rate={index.options.sample_rate}")
        self.index = index
        self.min_len = int(min_len)
        self.chunk = int(chunk)

    def _prior_flags(self, docs: list) -> list:
        """Per-doc bool[n_pos]: gram occurs in a previously-ingested shard."""
        g = self.min_len
        n_pos = [max(len(d) - g + 1, 0) for d in docs]
        flags = [np.zeros(k, bool) for k in n_pos]
        rows = [_doc_grams(d, g) for d in docs if len(d) >= g]
        if not rows or self.index.n == 0:
            return flags
        uniq, inv = np.unique(np.concatenate(rows), axis=0,
                              return_inverse=True)
        hit = np.zeros(len(uniq), bool)
        sigma = self.index.sigma
        # grams with symbols the prior corpus never used can't occur there
        askable = np.flatnonzero(uniq.max(axis=1) < sigma)
        for at in range(0, len(askable), self.chunk):
            sel = askable[at:at + self.chunk]
            hit[sel] = self.index.contains_batch(list(uniq[sel]))
        flat = hit[inv]
        at = 0
        for j, k in enumerate(n_pos):
            flags[j] = flat[at:at + k]
            at += k
        return flags

    def process_shard(self, docs: list) -> tuple[list, ShardStats]:
        """Dedup + ingest one shard; returns (kept_docs, stats)."""
        g = self.min_len
        st = ShardStats(docs=len(docs), chars=int(sum(len(d) for d in docs)))
        prior = self._prior_flags(docs)
        self.index.add_docs(docs, compact=False)      # the ONE build
        seg = self.index.segments[-1]
        flat = seg.index
        if getattr(flat, "sample_rate", 1) > 1:
            # the within-shard gram-run rule needs the rank of EVERY shard
            # position (dense SA + LCP) — build a transient dense index of
            # just this shard. Sparse segment construction bypasses the
            # builder cache entirely, so this dense build is still THE one
            # builder-cache build per shard (same layout: encode_docs of
            # the same docs ⇒ identical text/doc_starts).
            flat = SuffixArrayIndex.from_docs(
                docs, self.index.options.replace(sample_rate=1),
                sigma=self.index._sigma, device=self.index.device)
        within = duplicate_gram_flags(flat, g, keep_first=True)
        ends = flat._doc_ends
        kept = []
        for j, d in enumerate(docs):
            flags = within[flat.doc_starts[j]:ends[j]].copy()
            st.within_hits += int(flags.sum())
            st.prior_hits += int(prior[j].sum())
            flags[:len(prior[j])] |= prior[j]
            drop = gram_drop_mask(flags, g)
            st.dropped_chars += int(drop.sum())
            kept.append(d[~drop])
        st.kept_chars = st.chars - st.dropped_chars
        st.unique_grams = int(sum(len(p) for p in prior))
        return kept, st


class ContaminationGate:
    """Train/eval firewall: exact-substring overlap of training windows
    against a held-out eval set, measured gram-by-gram.

    A window is *flagged* when more than ``max_hits`` of its
    ``min_len``-grams occur in the eval index; all grams of a whole batch
    of windows resolve in one (chunked) `count_batch` call on the
    deduplicated gram set. `check` is pure; the policy (reject vs mask)
    is applied by the data plane's `batch_at`."""

    def __init__(self, eval_docs, *, min_len: int = DEDUP_MIN_LEN,
                 options: SAOptions | None = None, sigma: int | None = None,
                 max_hits: int = 0, chunk: int = 4096, device="cuda"):
        docs = [np.asarray(d, np.int64).ravel() for d in eval_docs]
        self.index = SuffixArrayIndex.from_docs(docs, options, sigma=sigma,
                                                device=device)
        if int(min_len) < self.index.min_pattern_len:
            raise ValueError(
                f"gate min_len={min_len} is below the eval index's minimum "
                f"answerable pattern length "
                f"({self.index.min_pattern_len} = its sample_rate) — the "
                f"gate's grams could not be checked exactly")
        self.min_len = int(min_len)
        self.max_hits = int(max_hits)
        self.chunk = int(chunk)
        self.stats = {"checked_windows": 0, "flagged_windows": 0,
                      "rejected_windows": 0, "masked_windows": 0,
                      "grams_queried": 0}

    def check(self, windows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hits int64[W], contaminated bool[W, L]) for a [W, L] batch.

        ``hits[w]`` counts gram starts of window w present in the eval
        set; ``contaminated[w]`` paints the union of their ``[p, p +
        min_len)`` intervals (the char positions a mask policy zeroes
        out)."""
        windows = np.asarray(windows, np.int64)
        W, L = windows.shape
        g = self.min_len
        hits = np.zeros(W, np.int64)
        contaminated = np.zeros((W, L), bool)
        self.stats["checked_windows"] += W
        if L < g or self.index.n == 0 or W == 0:
            return hits, contaminated
        grams = np.lib.stride_tricks.sliding_window_view(windows, g, axis=1)
        P = grams.shape[1]
        uniq, inv = np.unique(grams.reshape(-1, g), axis=0,
                              return_inverse=True)
        hit = np.zeros(len(uniq), bool)
        sigma = self.index.sigma
        askable = np.flatnonzero((uniq.min(axis=1) >= 0)
                                 & (uniq.max(axis=1) < sigma))
        for at in range(0, len(askable), self.chunk):
            sel = askable[at:at + self.chunk]
            hit[sel] = self.index.count_batch(list(uniq[sel])) > 0
        self.stats["grams_queried"] += len(askable)
        flags = hit[inv].reshape(W, P)
        hits = flags.sum(axis=1)
        rows, cols = np.nonzero(flags)
        delta = np.zeros((W, L + 1), np.int64)
        np.add.at(delta, (rows, cols), 1)
        np.add.at(delta, (rows, np.minimum(cols + g, L)), -1)
        contaminated = np.cumsum(delta[:, :L], axis=1) > 0
        self.stats["flagged_windows"] += int((hits > self.max_hits).sum())
        return hits, contaminated


class MemorizationProbe:
    """Longest-verbatim-copy metrics for generated samples vs an index.

    `run` scores each sample by `longest_match` against the (streaming)
    training index — the length of the longest substring the model emitted
    verbatim from its training data — and summarises max/mean plus the
    fraction at or above ``min_len`` (the same bar the dedup stage uses:
    a copy that long would itself have been a dedup candidate)."""

    def __init__(self, index, *, min_len: int = DEDUP_MIN_LEN):
        self.index = index
        self.min_len = int(min_len)

    def run(self, samples) -> dict:
        lens = [int(self.index.longest_match(np.asarray(s).ravel()))
                for s in samples]
        if not lens:
            return {"samples": 0, "longest_copy_max": 0,
                    "longest_copy_mean": 0.0, "frac_memorized": 0.0,
                    "min_len": self.min_len}
        arr = np.asarray(lens, np.int64)
        return {"samples": len(lens),
                "longest_copy_max": int(arr.max()),
                "longest_copy_mean": float(arr.mean()),
                "frac_memorized": float((arr >= self.min_len).mean()),
                "min_len": self.min_len}


class TrainingDataPlane:
    """The staged data plane: shards in, gated deterministic batches out.

    Construction wires the stages from one `PipelineConfig`:

    * ``cfg.dedup`` → a `StreamingDedup` over a fresh `SegmentedIndex`
      (also reachable as ``plane.index`` for the probe);
    * ``eval_docs`` → a `ContaminationGate` applied inside `batch_at`;
    * `probe(samples)` → `MemorizationProbe` over the training index.

    `batch_at(step)` is a pure function of ``(cfg.seed, step)`` given the
    ingested corpus and eval set — gate rejections resample from the same
    deterministic stream, so restore-and-replay reproduces batches
    exactly. When a gate is attached, batches always carry a
    ``loss_mask`` key ([B, seq_len] float32, 1 = count the target) so the
    train-step pytree structure never changes between steps."""

    def __init__(self, cfg: PipelineConfig, *, eval_docs=None, shards=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.options = cfg.options if cfg.options is not None else SAOptions()
        self.index = (SegmentedIndex(options=self.options, sigma=cfg.vocab,
                                     device=self.device)
                      if cfg.wants_index else None)
        self.dedup = (StreamingDedup(self.index, cfg.dedup_min_len)
                      if cfg.dedup else None)
        self.gate = (ContaminationGate(
            eval_docs, min_len=cfg.gate_min_len, options=self.options,
            sigma=cfg.vocab, max_hits=cfg.gate_max_hits, device=self.device)
            if eval_docs is not None else None)
        self.report = PlaneReport()
        self.shard_stats: list[ShardStats] = []
        self._kept: list[np.ndarray] = []
        self._corpus: np.ndarray | None = None
        for shard in (shards if shards is not None else []):
            self.ingest_shard(shard)

    # -------------------------------------------------------------- ingest
    def ingest_shard(self, docs) -> ShardStats:
        """Push one shard (a list of documents) through dedup + indexing.
        Exactly one segment build when an index is attached (asserted via
        builder-cache deltas in tests); `compact_every` adds merge builds
        on top, every that-many shards."""
        docs = [np.asarray(d, np.int64).ravel() for d in docs]
        if not docs:
            return ShardStats()
        before = _builds()
        if self.dedup is not None:
            kept, st = self.dedup.process_shard(docs)
        else:
            if self.index is not None:
                self.index.add_docs(docs, compact=False)
            kept = docs
            st = ShardStats(docs=len(docs),
                            chars=int(sum(len(d) for d in docs)),
                            kept_chars=int(sum(len(d) for d in docs)))
        if (self.index is not None and self.cfg.compact_every
                and (self.report.shards + 1) % self.cfg.compact_every == 0):
            self.index.compact()
        st.builds = _builds() - before
        self.report.absorb(st)
        self.shard_stats.append(st)
        self._kept.extend(kept)
        self._corpus = None
        return st

    # ------------------------------------------------------------ batching
    @property
    def corpus(self) -> np.ndarray:
        """Every kept (post-dedup) document, packed flat for batching."""
        if self._corpus is None:
            self._corpus = (np.concatenate(self._kept).astype(np.int32)
                            if self._kept else np.zeros(0, np.int32))
        return self._corpus

    @property
    def n(self) -> int:
        return len(self.corpus)

    @property
    def window(self) -> int:
        return self.cfg.seq_len + 1

    @property
    def n_windows(self) -> int:
        return max(1, self.n - self.window)

    def _windows(self, starts) -> np.ndarray:
        corpus = self.corpus
        return np.stack([corpus[s:s + self.window] for s in starts])

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        toks = self._windows(rng.integers(0, self.n_windows,
                                          size=cfg.global_batch))
        if self.gate is None:
            return {"tokens": toks.astype(np.int32)}
        hits, contaminated = self.gate.check(toks)
        bad = hits > cfg.gate_max_hits
        if cfg.gate_policy == "reject":
            rounds = 0
            while bad.any() and rounds < cfg.gate_max_resample:
                idx = np.flatnonzero(bad)
                self.gate.stats["rejected_windows"] += len(idx)
                toks[idx] = self._windows(
                    rng.integers(0, self.n_windows, size=len(idx)))
                hits[idx], contaminated[idx] = self.gate.check(toks[idx])
                bad = np.zeros_like(bad)
                bad[idx] = hits[idx] > cfg.gate_max_hits
                rounds += 1
        # windows still over threshold (mask policy, or reject ran out of
        # redraws) train with their contaminated targets masked out
        self.gate.stats["masked_windows"] += int(bad.sum())
        keep = ~(contaminated & bad[:, None])
        loss_mask = keep[:, 1:].astype(np.float32)   # target t = token t+1
        return {"tokens": toks.astype(np.int32), "loss_mask": loss_mask}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # --------------------------------------------------------------- probe
    def probe(self, samples, *, min_len: int | None = None) -> dict:
        """Memorization metrics for decoded `samples` against the training
        index (requires the plane to have one — dedup or build_index)."""
        if self.index is None:
            raise RuntimeError(
                "the plane has no training index (enable cfg.dedup or "
                "cfg.build_index) — nothing to probe against")
        probe = MemorizationProbe(
            self.index, min_len=(self.cfg.probe_min_len
                                 if min_len is None else min_len))
        return probe.run(samples)

    def gate_stats(self) -> dict:
        return dict(self.gate.stats) if self.gate is not None else {}

    def __repr__(self) -> str:
        return (f"TrainingDataPlane(shards={self.report.shards}, "
                f"docs={self.report.docs}, n={self.n}, "
                f"dedup={self.dedup is not None}, "
                f"gate={self.gate is not None})")


class TokenPipeline:
    """Legacy facade: one flat corpus through the plane as a single shard.

    Packs a token corpus into [global_batch, seq_len + 1] LM batches.
    Deterministic given (seed, step): `batch_at(step)` is a pure function —
    resume after failure = start calling from the restored step. With
    ``cfg.dedup`` the corpus goes through the streaming dedup stage (a
    single-shard stream is byte-identical to the monolithic path)."""

    def __init__(self, corpus: np.ndarray, cfg: PipelineConfig, *,
                 device="cuda"):
        self.cfg = cfg
        self._plane = TrainingDataPlane(cfg, device=device)
        self._plane.ingest_shard([np.asarray(corpus).ravel()])
        self.dedup_report = self._plane.report if cfg.dedup else None
        self.corpus = self._plane.corpus
        self.n = self._plane.n
        self.window = self._plane.window
        self.n_windows = self._plane.n_windows

    def batch_at(self, step: int) -> dict:
        return self._plane.batch_at(step)

    def __iter__(self):
        return iter(self._plane)
