"""Request coalescing: individual queries → pow2 `(batch, length)` buckets.

The batched search (`repro_torch.api.query._ranges_kernel`) amortises
its launch overhead over a whole batch, but concurrent clients submit one
pattern at a time. The `Coalescer` is the piece in between: it holds
pending requests in per-length-bucket queues (the same
`pow2_bucket(len, floor=8)` grid `QueryBatch` pads to, so every batch it
emits lands on a shape the serving tier warmed) and closes a batch
window on the first of two triggers:

* **full bucket** — a length bucket reaches `max_batch` requests; the
  full chunk is emitted immediately (a burst larger than the biggest
  bucket simply emits several full chunks and leaves the remainder
  pending);
* **deadline** — the *oldest* request in a bucket reaches `max_wait_us`;
  the whole bucket is flushed (younger requests ride along — a lone
  straggler is never stranded longer than the max wait).

The class is intentionally free of threads and wall clocks: every method
takes `now` (seconds, `time.perf_counter` timebase) from the caller, so
tests can drive it with a purely virtual clock. `SAServer` owns the real
clock and the locking discipline (all coalescer calls happen under the
server's condition lock).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..api.query import _MIN_LEN_BUCKET, pow2_bucket


@dataclass
class PendingQuery:
    """One accepted, not-yet-served request."""

    req_id: int
    pattern: np.ndarray          # already through index._encode_pattern
    t_arrival: float             # seconds; scheduled arrival under open loop
    future: object = None        # concurrent.futures.Future[Response]
    len_bucket: int = field(init=False)

    def __post_init__(self):
        self.len_bucket = pow2_bucket(len(self.pattern),
                                      floor=_MIN_LEN_BUCKET)


class Coalescer:
    """Per-length-bucket pending queues with full/deadline batch windows."""

    def __init__(self, *, max_batch: int = 256, max_wait_us: float = 500.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be ≥ 0, got {max_wait_us}")
        #: batches are emitted at a pow2 batch bucket
        self.max_batch = pow2_bucket(max_batch)
        self.max_wait_s = max_wait_us * 1e-6
        self._buckets: dict[int, collections.deque] = {}
        self._pending = 0

    # ------------------------------------------------------------- state
    def pending_count(self) -> int:
        return self._pending

    def oldest_age_us(self, now: float) -> float:
        """Age of the oldest pending request, 0.0 when empty."""
        oldest = self._oldest_arrival()
        return 0.0 if oldest is None else max(now - oldest, 0.0) * 1e6

    def _oldest_arrival(self) -> Optional[float]:
        arrivals = [q[0].t_arrival for q in self._buckets.values() if q]
        return min(arrivals) if arrivals else None

    def next_deadline(self) -> Optional[float]:
        """Absolute time the earliest pending window must close, or None."""
        oldest = self._oldest_arrival()
        return None if oldest is None else oldest + self.max_wait_s

    # ------------------------------------------------------------ intake
    def add(self, req: PendingQuery) -> None:
        self._buckets.setdefault(req.len_bucket, collections.deque()) \
            .append(req)
        self._pending += 1

    def shed_oldest(self) -> Optional[PendingQuery]:
        """Remove and return the single oldest pending request (the
        overload_policy="shed" victim), or None when empty."""
        best_key, best_t = None, None
        for key, q in self._buckets.items():
            if q and (best_t is None or q[0].t_arrival < best_t):
                best_key, best_t = key, q[0].t_arrival
        if best_key is None:
            return None
        self._pending -= 1
        return self._buckets[best_key].popleft()

    # ----------------------------------------------------------- windows
    def pop_ready(self, now: float, *, flush: bool = False) -> list:
        """Batches whose window closed by `now` — list of PendingQuery
        lists, each a single (length-bucket, ≤ max_batch) batch in arrival
        order. `flush=True` closes every window regardless of age (server
        shutdown)."""
        out = []
        for key in sorted(self._buckets):
            q = self._buckets[key]
            while len(q) >= self.max_batch:           # full windows first
                out.append([q.popleft() for _ in range(self.max_batch)])
            if q and (flush or
                      now - q[0].t_arrival >= self.max_wait_s):
                out.append(list(q))
                q.clear()
        self._pending -= sum(len(b) for b in out)
        return out
