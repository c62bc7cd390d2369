"""Batched query execution — many patterns, one vectorised search.

* `QueryBatch` encodes many patterns into ONE padded buffer
  (`int[B_pad, L_pad]` + per-row lengths), with both axes quantised onto a
  power-of-two grid.
* `stage_batch` starts the host→device copy of a batch from pinned memory
  on a side CUDA stream and records an event behind it, so the copy of
  the next batch rides under the search of the current one (the serving
  tier's double buffer, `repro_torch.serve.SAServer`).
* `batch_ranges` runs the **vectorised double binary search**
  (`_ranges_kernel`): all B patterns advance their (lower, upper) SA
  bounds in lock-step; every step is one `[B, 2, L]` gather of text
  windows and one masked prefix comparison. Results come back as numpy
  int64 arrays, the layout of the JAX package's query engine.
* `QuerySession` is the closed-loop serving facade: it chops a pattern
  stream into ticks of at most `batch_size`, runs each tick as one batch
  and keeps per-tick latency records (`latency_summary()`: p50/p95/p99
  and qps); `submit` starts an `SAServer` for open-loop traffic.

`query_cache_stats()` counts the shapes the dense and sparse searches
have run at, hits and misses. There is no compile behind a shape here,
unlike the JAX package's jit cache: a shape is the (B_pad, L_pad, dtype) of the search's
windows, whatever the index, and a miss is the first batch at a shape,
the one that fills the caching allocator's pools. The JAX package's
`trace_events` (a count of jax traces) has no counterpart.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

#: (search, B_pad, L_pad, pattern dtype) shapes the searches have run at
#: (a bounded set: both pads are powers of two) and the misses, written
#: under the lock, which a hit never takes. Hits are counted per thread
#: (the serving tier's device thread and callers' threads search
#: concurrently), so each count has one writer.
_SEEN_BUCKETS: set[tuple] = set()
_MISSES = [0]
_HITS: dict[int, int] = {}
_CACHE_LOCK = threading.Lock()


def query_cache_stats() -> dict:
    """Snapshot of the query-shape accounting: buckets / hits / misses."""
    with _CACHE_LOCK:
        return {"buckets": len(_SEEN_BUCKETS),
                "hits": sum(list(_HITS.values())), "misses": _MISSES[0]}


def clear_query_cache() -> None:
    """Reset the bucket bookkeeping and the hit/miss counters."""
    with _CACHE_LOCK:
        _SEEN_BUCKETS.clear()
        _HITS.clear()
        _MISSES[0] = 0


def note_shape(search: str, batch: "QueryBatch") -> None:
    """Count one search of `batch`'s shape as a hit or a miss."""
    key = (search, *batch.bucket, np.dtype(batch.pats.dtype).str)
    if key not in _SEEN_BUCKETS:
        with _CACHE_LOCK:
            if key not in _SEEN_BUCKETS:
                _MISSES[0] += 1
                _SEEN_BUCKETS.add(key)
                return
    tid = threading.get_ident()
    _HITS[tid] = _HITS.get(tid, 0) + 1


#: pattern-length buckets never go below this (tiny patterns share shapes).
_MIN_LEN_BUCKET = 8


def pow2_bucket(m: int, floor: int = 1) -> int:
    """Smallest power of two ≥ max(m, floor)."""
    m = max(int(m), floor, 1)
    return 1 << (m - 1).bit_length()


class QueryBatch:
    """Many encoded patterns in one padded, bucketed buffer.

    Rows are patterns *after* `SuffixArrayIndex._encode_pattern` (shift
    applied, alphabet validated); `lens[i]` is the true length of row i and
    columns past it are padding (masked in the search). Both axes are
    padded up to power-of-two buckets (`L` has a floor of 8); padded rows
    have length 0 and are sliced off the results.

    A `QueryBatch` is **bound to the index that encoded it** (the
    shift/sigma are baked into the values): running it against any other
    index raises `ValueError`.
    """

    __slots__ = ("pats", "lens", "n_queries", "_index_ref")

    def __init__(self, pats: np.ndarray, lens: np.ndarray, n_queries: int,
                 index=None):
        self.pats = pats            # int[B_pad, L_pad], encoded + padded
        self.lens = lens            # int32[B_pad], 0 for padding rows
        self.n_queries = int(n_queries)
        self._index_ref = (weakref.ref(index) if index is not None
                           else lambda: None)

    def check_bound_to(self, index) -> None:
        """Raise unless this batch was encoded by `index`."""
        if self._index_ref() is not index:
            raise ValueError(
                "QueryBatch was encoded against a different index (or one "
                "that no longer exists) — re-encode with "
                "QueryBatch.encode(index, patterns)")

    @classmethod
    def encode(cls, index, patterns, dtype=np.int32) -> "QueryBatch":
        """Encode `patterns` (a sequence of int sequences) against `index`."""
        return cls.from_encoded(index, [index._encode_pattern(p)
                                        for p in patterns], dtype)

    @classmethod
    def from_encoded(cls, index, enc, dtype=np.int32) -> "QueryBatch":
        """Build a batch from patterns already passed through
        `index._encode_pattern`."""
        B = len(enc)
        max_len = max((len(p) for p in enc), default=0)
        pats = np.zeros((pow2_bucket(B),
                         pow2_bucket(max_len, floor=_MIN_LEN_BUCKET)), dtype)
        lens = np.zeros(pats.shape[0], np.int32)
        cap = np.iinfo(dtype).max
        for i, p in enumerate(enc):
            if len(p) and int(p.max()) >= cap:
                # every text symbol is < cap (enforced by _device_state), so
                # clamping keeps every text-vs-pattern comparison exact
                # instead of wrapping to a false match.
                p = np.minimum(p, cap)
            pats[i, :len(p)] = p
            lens[i] = len(p)
        return cls(pats, lens, B, index=index)

    @property
    def bucket(self) -> tuple[int, int]:
        """(B_pad, L_pad) — the padded shape this batch runs at."""
        return tuple(self.pats.shape)

    def __len__(self) -> int:
        return self.n_queries

    def __repr__(self) -> str:
        return (f"QueryBatch(n_queries={self.n_queries}, "
                f"bucket={self.bucket})")


def _ranges_kernel(text: torch.Tensor, sa: torch.Tensor, pats: torch.Tensor,
                   lens: torch.Tensor):
    """Vectorised double binary search: all patterns, both bounds, at once.

    text int32[n], sa int64[n], pats int32[B, L], lens int32[B], all on one
    device. For each pattern row two binary-search states run over SA
    ranks — bound 0 converges to the first suffix ≥ pattern, bound 1 to the
    first suffix > pattern (prefix match counts as equal), so `[lo, hi)`
    is the block of suffixes starting with the pattern. Every step probes
    both bounds of every pattern with one `[B, 2, L]` gather and one masked
    3-way prefix comparison (past-the-end reads as -1, below every real
    character). Rows of length 0 resolve to (0, n). The step count is
    ceil(log2(n + 1)) + 1, a Python loop of PyTorch ops.
    Returns (lo int64[B], hi int64[B]) on the device.
    """
    n = text.shape[0]
    B, L = pats.shape
    device = text.device
    steps = max(int(n).bit_length(), 1) + 1
    col = torch.arange(L, device=device)
    pat = pats[:, None, :].expand(B, 2, L)
    valid = col[None, None, :] < lens[:, None, None]
    lo = torch.zeros((B, 2), dtype=torch.int64, device=device)
    hi = torch.full((B, 2), n, dtype=torch.int64, device=device)
    for _ in range(steps):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        start = sa[torch.where(active, mid, 0)]                 # [B, 2]
        idx = start[..., None] + col                            # [B, 2, L]
        chars = torch.where(idx < n, text[idx.clamp(max=n - 1)], -1)
        diff = (chars != pat) & valid
        any_diff = diff.any(dim=-1)
        # torch.argmax takes no bool input; the first 1 is the first diff
        first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)
        s_at = chars.gather(-1, first)[..., 0]
        p_at = pat.gather(-1, first)[..., 0]
        less = any_diff & (s_at < p_at)          # suffix < pattern
        greater = any_diff & (s_at > p_at)       # suffix > pattern
        # bound 0 moves right while suffix < pat; bound 1 while suffix ≤ pat
        before = torch.stack([less[:, 0], ~greater[:, 1]], dim=1)
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo[:, 0], lo[:, 1]


class StagedBatch(NamedTuple):
    """A batch's buffers on the index's device, and the event recorded on
    the copy stream behind their copies (None off the card)."""

    pats: torch.Tensor
    lens: torch.Tensor
    ready: Optional[torch.cuda.Event]


#: `stage_batch`'s copy stream of each card, made on its first use.
_COPY_STREAMS: dict[int, torch.cuda.Stream] = {}


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _COPY_STREAMS.get(key)
    if stream is None:
        # setdefault is atomic: racing first calls share one stream
        stream = _COPY_STREAMS.setdefault(key, torch.cuda.Stream(dev))
    return stream


def stage_batch(index, batch: QueryBatch) -> StagedBatch:
    """Begin the host→device copy of a batch's buffers.

    On the card the buffers are pinned and copied `non_blocking` on the
    card's copy stream, with an event recorded behind the copies; the
    caller's stream is not touched, so a copy started while a search is
    queued there overlaps it. `batch_ranges(..., staged=)` makes its
    stream wait on the event. Off the card the buffers are copied on
    return."""
    batch.check_bound_to(index)
    dev = index.device
    pats = torch.from_numpy(batch.pats)
    lens = torch.from_numpy(batch.lens)
    if dev.type != "cuda":
        return StagedBatch(pats.to(dev), lens.to(dev), None)
    copy = _copy_stream(dev)
    with torch.cuda.stream(copy):
        pats_d = pats.pin_memory().to(dev, non_blocking=True)
        lens_d = lens.pin_memory().to(dev, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(copy)
    return StagedBatch(pats_d, lens_d, ready)


def batch_buffers(index, batch: QueryBatch,
                  staged: StagedBatch | None) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(pats, lens) on the index's device, ready for work queued on the
    current stream.

    Unstaged, they are copied on that stream. Staged, that stream waits
    on the copy's event, and the buffers are marked as used by it, so the
    caching allocator does not hand their memory out again before the
    search that reads them has run."""
    if staged is None:
        dev = index.device
        pats = torch.from_numpy(batch.pats)
        lens = torch.from_numpy(batch.lens)
        if dev.type == "cuda":
            pats, lens = pats.pin_memory(), lens.pin_memory()
        return (pats.to(dev, non_blocking=True),
                lens.to(dev, non_blocking=True))
    if staged.ready is not None:
        stream = torch.cuda.current_stream(index.device)
        stream.wait_event(staged.ready)
        staged.pats.record_stream(stream)
        staged.lens.record_stream(stream)
    return staged.pats, staged.lens


def batch_ranges(index, batch: QueryBatch, *,
                 staged: StagedBatch | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Resolve every pattern in `batch` to its `[lo, hi)` SA-rank range.

    One vectorised search for the whole batch; returns two
    int64[n_queries] numpy arrays (padding rows sliced off). An empty index
    maps every pattern to (0, 0). Pass `staged=stage_batch(...)` to run
    against buffers whose copy was already started.
    """
    batch.check_bound_to(index)
    k = batch.n_queries
    if index.n == 0 or k == 0:
        z = np.zeros(k, np.int64)
        return z, z.copy()
    text_d, sa_d = index._device_state()
    note_shape("dense", batch)
    pats_d, lens_d = batch_buffers(index, batch, staged)
    lo, hi = _ranges_kernel(text_d, sa_d, pats_d, lens_d)
    both = torch.stack([lo[:k], hi[:k]]).cpu().numpy()
    return both[0], both[1]


class QuerySession:
    """Closed-loop serving facade: batched query ticks + latency accounting.

    Wraps one `SuffixArrayIndex` (built, or restored from an `IndexStore`)
    or a `repro_torch.api.SegmentedIndex` (whose `count_batch` fans each
    tick across segments and merges; locate then yields global (doc,
    offset) rows). An incoming sequence of patterns is chopped into ticks
    of at most `batch_size`, each tick runs as one batch, and the wall
    time of every tick, up to its results on the host, is recorded.
    `latency_summary()` reports per-query p50/p95/p99 latency (a query's
    latency is its tick's wall time) and the aggregate qps.
    """

    def __init__(self, index, *, batch_size: int = 64):
        if batch_size < 1:
            raise ValueError(f"batch_size must be ≥ 1, got {batch_size}")
        self.index = index
        self.batch_size = int(batch_size)
        self._tick_us: list[float] = []     # wall µs per tick
        self._tick_sizes: list[int] = []    # queries per tick
        self._warmup_ticks = 0
        self._server = None                 # lazy repro_torch.serve.SAServer

    # ------------------------------------------------------------ serving
    def _ticks(self, patterns):
        pats = list(patterns)
        for at in range(0, len(pats), self.batch_size):
            yield pats[at:at + self.batch_size]

    def _timed(self, fn, tick):
        t0 = time.perf_counter()
        out = fn(tick)
        self._tick_us.append(1e6 * (time.perf_counter() - t0))
        self._tick_sizes.append(len(tick))
        return out

    def warmup(self, pattern_lens=(8,)) -> int:
        """Run one unrecorded tick of `batch_size` patterns per length in
        `pattern_lens`.

        There is no compile to pay here, but the first tick at a shape
        fills the caching allocator's pools and the pinned host pool that
        later ticks of that shape reuse. Warmed ticks are counted
        (`latency_summary()["warmup_ticks"]`) but never enter the
        percentile pool. Returns the tick count run."""
        done = 0
        for m in pattern_lens:
            # floor by the index's minimum answerable length (a sparse
            # index rejects shorter patterns)
            m = max(int(m), 1,
                    int(getattr(self.index, "min_pattern_len", 0)))
            if self.index.n == 0 or self.index.sigma == 0:
                continue        # nothing to search / no alphabet
            # value 0 is always in-alphabet when sigma ≥ 1
            self.index.count_batch([np.zeros(m, np.int64)] * self.batch_size)
            self._warmup_ticks += 1
            done += 1
        return done

    def count(self, patterns) -> np.ndarray:
        """Occurrence counts for a stream of patterns — int64[len]."""
        outs = [self._timed(self.index.count_batch, t)
                for t in self._ticks(patterns)]
        return (np.concatenate(outs) if outs else np.zeros(0, np.int64))

    def contains(self, patterns) -> np.ndarray:
        """Presence flags for a stream of patterns — bool[len]."""
        return self.count(patterns) > 0

    def locate(self, patterns) -> list:
        """Sorted occurrence positions per pattern — list of int64 arrays."""
        outs: list = []
        for t in self._ticks(patterns):
            outs.extend(self._timed(self.index.locate_batch, t))
        return outs

    # --------------------------------------------------------- accounting
    @property
    def queries_served(self) -> int:
        return int(sum(self._tick_sizes))

    def latency_summary(self) -> dict:
        """Aggregate latency stats over every *recorded* tick so far.

        Warmup ticks are excluded (only their count is reported). With no
        recorded ticks the percentiles and qps are ``None`` (absent, not
        zero)."""
        if not self._tick_us:
            return {"ticks": 0, "queries": 0,
                    "warmup_ticks": self._warmup_ticks,
                    "p50_us": None, "p95_us": None, "p99_us": None,
                    "qps": None}
        per_query = np.repeat(np.asarray(self._tick_us),
                              np.asarray(self._tick_sizes))
        p50, p95, p99 = np.percentile(per_query, [50, 95, 99])
        total_s = float(np.sum(self._tick_us)) * 1e-6
        return {
            "ticks": len(self._tick_us),
            "queries": self.queries_served,
            "warmup_ticks": self._warmup_ticks,
            "p50_us": float(p50),
            "p95_us": float(p95),
            "p99_us": float(p99),
            "qps": self.queries_served / max(total_s, 1e-9),
        }

    def reset_latency(self) -> None:
        self._tick_us.clear()
        self._tick_sizes.clear()
        self._warmup_ticks = 0

    # ------------------------------------------------- non-blocking submit
    def submit(self, pattern, **server_knobs):
        """Submit ONE pattern without blocking; returns a future.

        The first call starts a `repro_torch.serve.SAServer` over this
        session's index (`max_batch=batch_size`; pass coalescing and
        admission knobs as keyword arguments on that first call). The
        future resolves to a `repro_torch.serve.Response` whose `.count`
        is the occurrence count. Async traffic is accounted in
        `server.metrics`, not in the tick stats. Call `close()` (or use
        the session as a context manager) to drain and stop the loop.
        """
        if self._server is None:
            from ..serve import SAServer
            self._server = SAServer(self.index, max_batch=self.batch_size,
                                    **server_knobs)
            self._server.start()
        elif server_knobs:
            raise ValueError("server knobs only apply to the first submit "
                             "(the serving loop is already running)")
        return self._server.submit(pattern)

    @property
    def server(self):
        """The lazily started `repro_torch.serve.SAServer`, or None."""
        return self._server

    def close(self) -> None:
        """Drain and stop the async serving loop (no-op if never started)."""
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self) -> "QuerySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"QuerySession(index=n{self.index.n}, "
                f"batch_size={self.batch_size}, "
                f"served={self.queries_served})")
