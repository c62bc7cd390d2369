"""repro_torch.serve — the asynchronous serving tier over the query engine.

The port of `repro.serve`. `repro_torch.api.QuerySession` answers
closed-loop batches; this package serves many independent clients, one
small request each:

* `Coalescer` merges individual requests into the pow2 (batch, length)
  buckets the batched search runs at, closing each window on a full
  bucket or a max-wait deadline (`coalescer`);
* `AdmissionController` bounds the queue and applies an overload policy
  — reject-with-retry-after or shed-oldest (`admission`);
* `SAServer` runs the loop: non-blocking `submit()` → coalesce →
  host→device staging on a side CUDA stream against the search in flight
  → futures resolved with per-request latency breakdowns (`server`);
* `ServeMetrics` measures queue-wait/service/total histograms, batch
  sizes, bucket occupancy and admission counters (`metrics`);
* `make_arrivals` / `run_open_loop` / `summarize` generate seeded
  Poisson / bursty ON-OFF open-loop load and fold the responses into one
  record (`loadgen`).

Quickstart (tiny, on the CPU)
-----------------------------
>>> import numpy as np
>>> from repro_torch.api import SuffixArrayIndex
>>> from repro_torch.serve import SAServer
>>> idx = SuffixArrayIndex.build(np.array([0, 2, 1, 0, 0, 2, 1, 0]),
...                              sigma=4, device="cpu")
>>> with SAServer(idx, max_batch=4, coalesce_max_wait_us=200.0) as srv:
...     futs = [srv.submit([0, 2]), srv.submit([1, 0]), srv.submit([3])]
...     counts = [f.result().count for f in futs]
>>> counts
[2, 2, 0]
"""
from .admission import AdmissionController, AdmissionDecision, POLICIES
from .coalescer import Coalescer, PendingQuery
from .loadgen import ARRIVALS, make_arrivals, run_open_loop, summarize
from .metrics import Histogram, ServeMetrics
from .server import Response, SAServer

__all__ = [
    "ARRIVALS",
    "AdmissionController",
    "AdmissionDecision",
    "Coalescer",
    "Histogram",
    "POLICIES",
    "PendingQuery",
    "Response",
    "SAServer",
    "ServeMetrics",
    "make_arrivals",
    "run_open_loop",
    "summarize",
]
