"""Serving-tier metrics: latency histograms, batch shape distributions,
admission counters.

Every claim the serving tier makes is measured here, request by request:

* three per-request latency components, each its own `Histogram` —
  **queue wait** (arrival → batch dispatched to the device loop),
  **service** (dispatch → results resolved), and **total** (arrival →
  resolved; under open-loop load this starts at the request's *scheduled*
  arrival time, so submission-loop lateness counts against the server
  instead of being silently forgiven — the coordinated-omission guard);
* coalescing effectiveness — the distribution of coalesced batch sizes
  and of bucket occupancy (`n_queries / B_pad`, how full the padded
  pow2 bucket actually was);
* admission outcomes — monotone counters for submitted / accepted /
  rejected / shed / completed.

Percentiles of an empty histogram are ``None`` (absent), never 0.0 — the
same rule as `repro_torch.api.QuerySession.latency_summary` — so
aggregating a quiet window cannot drag an SLO report toward fictitious
zeros.
"""
from __future__ import annotations

import threading

import numpy as np


class Histogram:
    """Append-only sample store with percentile summaries.

    Raw float samples are kept (serving runs are bounded — minutes, not
    days — so exact percentiles beat bucketed approximations); `add` is
    thread-safe via one lock shared with the summary reader.
    """

    __slots__ = ("name", "_values", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._values: list[float] = []
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    def extend(self, values) -> None:
        with self._lock:
            self._values.extend(float(v) for v in values)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._values)

    def values(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._values, np.float64)

    def summary(self) -> dict:
        """count/mean/max + p50/p95/p99; absent (None) stats when empty."""
        v = self.values()
        if v.size == 0:
            return {"count": 0, "mean": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        p50, p95, p99 = np.percentile(v, [50, 95, 99])
        return {"count": int(v.size), "mean": float(v.mean()),
                "max": float(v.max()), "p50": float(p50),
                "p95": float(p95), "p99": float(p99)}


class ServeMetrics:
    """All serving-tier instrumentation for one `SAServer`."""

    #: admission/lifecycle counter names, in reporting order
    #: (gc_pauses: full collections observed while the serving loops ran —
    #: the GC-hygiene regime in `SAServer` keeps it near zero)
    COUNTERS = ("submitted", "accepted", "rejected", "shed", "completed",
                "gc_pauses")

    def __init__(self):
        self.queue_wait_us = Histogram("queue_wait_us")
        self.service_us = Histogram("service_us")
        self.total_us = Histogram("total_us")
        self.batch_size = Histogram("batch_size")
        self.bucket_occupancy = Histogram("bucket_occupancy")
        self._counters = {k: 0 for k in self.COUNTERS}
        self._lock = threading.Lock()

    def bump(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self._counters[counter] += by

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def record_batch(self, size: int, bucket_b: int) -> None:
        """One coalesced batch left for the device: its true size and how
        full the padded pow2 bucket was."""
        self.batch_size.add(size)
        self.bucket_occupancy.add(size / max(bucket_b, 1))

    def snapshot(self) -> dict:
        """One JSON-ready dict with every histogram summary + counters."""
        return {
            "counters": self.counters(),
            "queue_wait_us": self.queue_wait_us.summary(),
            "service_us": self.service_us.summary(),
            "total_us": self.total_us.summary(),
            "batch_size": self.batch_size.summary(),
            "bucket_occupancy": self.bucket_occupancy.summary(),
        }
