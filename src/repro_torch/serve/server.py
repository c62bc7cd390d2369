"""`SAServer` — the asynchronous serving loop over one suffix-array index.

The port of `repro.serve.server`, with the same threads, lock discipline
and metrics; the staging double buffer runs on CUDA streams and events.

Data path (one request's life):

    submit(pattern)                      [caller thread]
      validate + encode (ValueError raised synchronously)
      AdmissionController.admit(queue depth, oldest age)
        reject → completed future, Response(status="rejected", retry_after)
        shed   → oldest pending request is evicted, new one admitted
        accept → PendingQuery into the inbox, coalesce thread woken
    coalesce loop                        [thread 1]
      inbox → Coalescer buckets; windows close on full-bucket or
      max-wait deadline → index.stage_encoded (the host→device copy
      STARTS here, pinned, on a side stream, an event recorded behind
      it) → staging queue (depth 1)
    device loop                          [thread 2, in the index's device]
      staging queue → index.ranges_staged: the current stream waits on
      the copy's event, the staged buffers are marked as used by it, the
      search runs → block on results → resolve futures, record metrics

The index is either a monolithic `SuffixArrayIndex` (one `QueryBatch`,
one `_ranges_kernel` search), its sparse subclass, or a `SegmentedIndex`
(one staged batch per segment, counts merged) — the loops only speak the
staging protocol.

The staging queue of depth 1 is the double buffer: while the device loop
blocks on batch k's search, the coalesce thread encodes and stages batch
k+1, whose host→device copy runs on its own stream under the search in
flight (on the default stream it would queue behind it). When
both slots are busy the coalesce thread itself blocks, arrivals pile up
in the inbox, the measured queue depth grows, and admission control sees
the overload — backpressure propagates end to end instead of vanishing
into an unbounded buffer.

Latency accounting is per request: queue wait (arrival → batch left for
the device), service (device pickup → results resolved), total. Under
open-loop load `submit(..., t_arrival=scheduled)` dates the request from
its *scheduled* arrival, so loadgen lateness counts against the server
(no coordinated omission).
"""
from __future__ import annotations

import collections
import gc
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import contextlib

import numpy as np
import torch

from ..api.query import _MIN_LEN_BUCKET, pow2_bucket
from .admission import AdmissionController, POLICIES
from .coalescer import Coalescer, PendingQuery
from .metrics import ServeMetrics

__all__ = ["Response", "SAServer", "POLICIES"]

#: EMA weight for the per-request service-cost estimate (retry-after hints)
_EMA_ALPHA = 0.2

#: pinned GC thresholds while the serving loops run: gen-0/1 stay at the
#: CPython defaults, gen-2 is pushed out 1000× so full collections — the
#: pauses that walk the entire (index-sized) heap — can't fire mid-batch.
_SERVE_GC_THRESHOLDS = (700, 10, 10_000)


@dataclass(frozen=True)
class Response:
    """Terminal state of one submitted request.

    Over a monolithic `SuffixArrayIndex`, ``(lo, hi)`` is the SA-rank
    range of the matches. Over a `repro_torch.api.SegmentedIndex` or a
    sparse index, ranks don't compose into a dense global rank space, so
    ``(lo, hi)`` is the *virtual* range ``[0, count)`` — ``count`` is
    exact either way."""

    req_id: int
    status: str                          # "ok" | "rejected" | "shed"
    count: Optional[int] = None          # occurrences (status "ok")
    lo: Optional[int] = None             # SA-rank range (status "ok")
    hi: Optional[int] = None
    retry_after_us: Optional[float] = None   # backoff hint ("rejected")
    queue_us: Optional[float] = None
    service_us: Optional[float] = None
    total_us: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class SAServer:
    """Coalescing, admission-controlled serving loop over one index.

    `index` is a monolithic `repro_torch.api.SuffixArrayIndex` (dense or
    sparse) or a `repro_torch.api.SegmentedIndex` — each speaks the
    `_encode_pattern` / `stage_encoded` / `ranges_staged` staging
    protocol the loops are written against, so multi-segment corpora
    serve through the identical data path (per-segment searches fan out
    inside `ranges_staged`). The device loop runs inside
    ``torch.cuda.device(index.device)`` on the card.

    Parameters mirror `repro_torch.configs.SAConfig` serving knobs:

    * `max_batch` — largest coalesced batch (rounded up to a power of
      two: the largest batch bucket).
    * `coalesce_max_wait_us` — deadline for a non-full window; the extra
      latency a lone request can pay for the chance of sharing a search.
    * `queue_depth` / `overload_policy` / `max_queue_age_us` — admission
      control (`repro_torch.serve.admission`).
    * `gc_hygiene` — latency hygiene for the (process-global) cyclic GC:
      while the loops run, gen-2 thresholds are pinned high
      (`_SERVE_GC_THRESHOLDS`) so full heap walks can't land mid-batch,
      and after `warmup()` the loaded index and everything else alive
      are `gc.freeze()`-d out of every future collection. Any full
      collection that still happens in-loop bumps the `gc_pauses` metric
      counter.
      `stop()` restores the previous thresholds and unfreezes.
    """

    def __init__(self, index, *, max_batch: int = 256,
                 coalesce_max_wait_us: float = 500.0,
                 queue_depth: int = 1024,
                 overload_policy: str = "reject",
                 max_queue_age_us: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 gc_hygiene: bool = True):
        self.index = index
        self.coalescer = Coalescer(max_batch=max_batch,
                                   max_wait_us=coalesce_max_wait_us)
        self.admission = AdmissionController(queue_depth=queue_depth,
                                             policy=overload_policy,
                                             max_age_us=max_queue_age_us)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.warmed_shapes = 0
        self._ids = itertools.count()
        self._cond = threading.Condition()
        self._inbox: collections.deque = collections.deque()
        self._queued = 0                  # accepted, not yet on the device
        self._ema_us_per_req: Optional[float] = None
        self._stage_q: queue.Queue = queue.Queue(maxsize=1)
        self._running = False
        self._stopping = False
        self._threads: list[threading.Thread] = []
        self.gc_hygiene = gc_hygiene
        self._gc_saved_thresholds: Optional[tuple] = None
        self._gc_frozen = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "SAServer":
        if self._running:
            return self
        with self._cond:
            # `_stopping` is read by the coalesce loop; take the lock even
            # though the threads don't exist yet, so a racing stop()/start()
            # pair can't interleave the flag writes.
            self._running, self._stopping = True, False
        if self.gc_hygiene:
            self._gc_saved_thresholds = gc.get_threshold()
            gc.set_threshold(*_SERVE_GC_THRESHOLDS)
            gc.callbacks.append(self._on_gc)
        self._threads = [
            threading.Thread(target=self._coalesce_loop,
                             name="sa-serve-coalesce", daemon=True),
            threading.Thread(target=self._device_loop,
                             name="sa-serve-device", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain every pending request, then stop both loops (and hand the
        process-global GC state back the way it was found)."""
        if not self._running:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._running = False
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        if self._gc_frozen:
            gc.unfreeze()
            self._gc_frozen = False
        if self._gc_saved_thresholds is not None:
            gc.set_threshold(*self._gc_saved_thresholds)
            self._gc_saved_thresholds = None

    def _on_gc(self, phase: str, info: dict) -> None:
        """`gc.callbacks` hook: count full collections that land while the
        serving loops are live — each one is a stop-the-world heap walk the
        latency histograms would otherwise show as an anonymous p99 spike."""
        if (phase == "stop" and info.get("generation") == 2
                and self._running):
            self.metrics.bump("gc_pauses")

    def __enter__(self) -> "SAServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- warmup
    def warmup(self, pattern_lens=(8,), batch_buckets=None) -> int:
        """Run the shapes live traffic will hit once, off the clock.

        Coalesced batches can land on ANY pow2 batch bucket up to
        `max_batch`. There is no compile to pay here, but the first batch
        at each `(B_pad, L_pad)` fills the caching allocator's pools and
        the pinned host pool, a cost that would otherwise surface in the
        first requests' latency. Default warms every pow2 batch bucket ×
        every length bucket in `pattern_lens`. Returns the number of
        shapes run."""
        if self.index.n == 0 or self.index.sigma == 0:
            return 0
        if batch_buckets is None:
            b = self.coalescer.max_batch
            batch_buckets = [1 << k for k in range(b.bit_length())
                             if (1 << k) <= b]
        done = 0
        # a sparse index rejects patterns below its rate, and its real
        # traffic only ever lands on length buckets ≥ that rate — floor
        # the warmed shapes the same way
        floor = max(_MIN_LEN_BUCKET,
                    int(getattr(self.index, "min_pattern_len", 0)))
        for m in sorted({pow2_bucket(int(l), floor=floor)
                         for l in pattern_lens}):
            for b in batch_buckets:
                pats = [np.zeros(m, np.int64)] * int(b)
                self.index.count_batch(pats)
                done += 1
        self.warmed_shapes += done
        if self.gc_hygiene and done:
            # everything alive now — the index, its SA/LCP arrays, the
            # warmed pools' bookkeeping — is long-lived state. One
            # deliberate full collection while off the clock (not counted
            # as an in-loop pause), then freeze it all out of every future
            # GC pass.
            observed = self._on_gc in gc.callbacks
            if observed:
                gc.callbacks.remove(self._on_gc)
            gc.collect()
            gc.freeze()
            if observed:
                gc.callbacks.append(self._on_gc)
            self._gc_frozen = True
        return done

    # -------------------------------------------------------------- submit
    def submit(self, pattern, *, t_arrival: Optional[float] = None) -> Future:
        """Submit one pattern; returns a Future resolving to a `Response`.

        Never blocks on the device. Validation errors (out-of-alphabet
        values) raise synchronously; admission rejections resolve the
        future immediately with `status="rejected"` and a
        `retry_after_us` hint."""
        if not self._running or self._stopping:
            raise RuntimeError("SAServer is not running (call start())")
        enc = self.index._encode_pattern(pattern)   # raises on bad alphabet
        now = time.perf_counter()
        t_arrival = now if t_arrival is None else float(t_arrival)
        fut: Future = Future()
        req = PendingQuery(req_id=next(self._ids), pattern=enc,
                           t_arrival=t_arrival, future=fut)
        self.metrics.bump("submitted")
        with self._cond:
            decision = self.admission.admit(
                self._queued, self._oldest_age_us(now), self._ema_us_per_req)
            if decision.action == "reject":
                self.metrics.bump("rejected")
                fut.set_result(Response(
                    req_id=req.req_id, status="rejected",
                    retry_after_us=decision.retry_after_us,
                    total_us=(time.perf_counter() - t_arrival) * 1e6))
                return fut
            if decision.action == "shed":
                victim = self._shed_locked()
                if victim is not None:
                    self.metrics.bump("shed")
                    victim.future.set_result(Response(
                        req_id=victim.req_id, status="shed",
                        total_us=(now - victim.t_arrival) * 1e6))
            self.metrics.bump("accepted")
            self._inbox.append(req)
            self._queued += 1
            self._cond.notify_all()
        return fut

    def _oldest_age_us(self, now: float) -> float:
        """Oldest queued age across inbox + coalescer (caller holds lock)."""
        age = self.coalescer.oldest_age_us(now)
        if self._inbox:
            age = max(age, (now - self._inbox[0].t_arrival) * 1e6)
        return age

    def _shed_locked(self):
        """Evict the oldest queued request (caller holds the lock)."""
        victim = None
        if self._inbox and (self.coalescer.pending_count() == 0):
            victim = self._inbox.popleft()
        else:
            victim = self.coalescer.shed_oldest()
            if victim is None and self._inbox:
                victim = self._inbox.popleft()
        if victim is not None:
            self._queued -= 1
        return victim

    # ------------------------------------------------------ coalesce thread
    def _coalesce_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._inbox and not self._stopping
                       and self.coalescer.next_deadline() is None):
                    self._cond.wait()
                while self._inbox:
                    self.coalescer.add(self._inbox.popleft())
                stopping = self._stopping and not self._inbox
                now = time.perf_counter()
                batches = self.coalescer.pop_ready(now, flush=stopping)
                if not batches and not stopping:
                    deadline = self.coalescer.next_deadline()
                    if deadline is not None:
                        self._cond.wait(timeout=max(deadline - now, 0.0))
                        continue
            for reqs in batches:
                self._stage_and_enqueue(reqs)
            if stopping:
                self._stage_q.put(None)     # device-loop shutdown sentinel
                return

    def _stage_and_enqueue(self, reqs) -> None:
        """Encode + begin host→device transfer, then hand to the device
        loop. Runs OUTSIDE the lock: staging overlaps both new arrivals
        and the search in flight. Blocks when the staging slot is full —
        that is the backpressure edge."""
        work = self.index.stage_encoded([r.pattern for r in reqs])
        t_dispatch = time.perf_counter()
        self.metrics.record_batch(len(reqs), pow2_bucket(len(reqs)))
        self._stage_q.put((work, reqs, t_dispatch))

    # -------------------------------------------------------- device thread
    def _device_loop(self) -> None:
        dev = self.index.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            self._serve_staged()

    def _serve_staged(self) -> None:
        while True:
            item = self._stage_q.get()
            if item is None:
                return
            work, reqs, t_dispatch = item
            with self._cond:
                self._queued -= len(reqs)
            try:
                lo, hi = self.index.ranges_staged(work)
            except Exception as e:
                # the boundary that must keep serving: each request's
                # future carries the error (and its traceback) instead
                for r in reqs:
                    r.future.set_exception(e)
                continue
            t_done = time.perf_counter()
            service_us = (t_done - t_dispatch) * 1e6
            per_req = service_us / max(len(reqs), 1)
            with self._cond:
                # submit() reads the EMA under the lock for retry-after
                # hints; an unlocked read-modify-write here could publish a
                # torn/stale estimate to the admission controller.
                self._ema_us_per_req = (
                    per_req if self._ema_us_per_req is None else
                    _EMA_ALPHA * per_req +
                    (1 - _EMA_ALPHA) * self._ema_us_per_req)
            self.metrics.service_us.add(service_us)
            for r, l, h in zip(reqs, lo, hi):
                queue_us = (t_dispatch - r.t_arrival) * 1e6
                total_us = (t_done - r.t_arrival) * 1e6
                self.metrics.queue_wait_us.add(queue_us)
                self.metrics.total_us.add(total_us)
                self.metrics.bump("completed")
                r.future.set_result(Response(
                    req_id=r.req_id, status="ok", count=int(h - l),
                    lo=int(l), hi=int(h), queue_us=queue_us,
                    service_us=service_us, total_us=total_us))

    # --------------------------------------------------------------- intro
    def __repr__(self) -> str:
        c = self.metrics.counters()
        return (f"SAServer(n={self.index.n}, "
                f"max_batch={self.coalescer.max_batch}, "
                f"policy={self.admission.policy!r}, "
                f"running={self._running}, completed={c['completed']})")
