"""Open-loop load generation: seeded arrival processes + the submit loop.

Closed-loop benchmarks (send a batch, wait, send the next) can never
observe queueing collapse: the client slows down exactly when the server
does. SLO claims need **open-loop** load — arrivals are scheduled by the
process, not by the server's progress, so offered load past saturation
actually piles up. Three arrival processes, all driven by one seeded
`numpy` Generator (never wall-clock-seeded: the same seed produces the
same arrival schedule on every machine, and the same schedule as the
JAX package's `repro.serve.loadgen`):

* ``"uniform"`` — evenly spaced, deterministic; the degenerate baseline
  and the unit-test workhorse.
* ``"poisson"`` — i.i.d. exponential inter-arrivals at `qps`; the
  classic memoryless open-loop model.
* ``"onoff"``  — bursty Markov-modulated traffic: a Poisson process at
  peak rate `qps · (on+off)/on` thinned to ON windows of `on_ms` every
  `on_ms + off_ms`, so the *mean* rate is `qps` but the server sees
  alternating silence and `1/duty`-times-overload bursts.

`run_open_loop` replays a schedule against an `SAServer`: submissions
are never gated on completions, each request is dated from its
*scheduled* arrival (lateness of the submit loop is charged to measured
latency — no coordinated omission), and the collected `Response`
objects are folded into one summary dict by `summarize`.
"""
from __future__ import annotations

import time

import numpy as np

#: valid arrival-process spellings
ARRIVALS = ("uniform", "poisson", "onoff")


def make_arrivals(process: str, qps: float, duration_s: float, *,
                  seed: int = 0, on_ms: float = 50.0,
                  off_ms: float = 150.0) -> np.ndarray:
    """Sorted arrival offsets (seconds, float64) in [0, duration_s).

    Deterministic in (process, qps, duration_s, seed, on_ms, off_ms).
    """
    if process not in ARRIVALS:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(choose from {ARRIVALS})")
    if qps <= 0 or duration_s <= 0:
        raise ValueError("qps and duration_s must be > 0")
    rng = np.random.default_rng(seed)
    if process == "uniform":
        return np.arange(0.0, duration_s, 1.0 / qps)
    if process == "poisson":
        # draw in one vector slightly past the horizon, then trim
        est = int(qps * duration_s * 1.5) + 16
        t = np.cumsum(rng.exponential(1.0 / qps, size=est))
        while t.size and t[-1] < duration_s:
            t = np.concatenate(
                [t, t[-1] + np.cumsum(rng.exponential(1.0 / qps, size=est))])
        return t[t < duration_s]
    # onoff: homogeneous Poisson at the ON-window peak rate, thinned to ON
    on_s, off_s = on_ms * 1e-3, off_ms * 1e-3
    period = on_s + off_s
    duty = on_s / period
    peak = qps / duty
    t = make_arrivals("poisson", peak, duration_s, seed=seed)
    return t[(t % period) < on_s]


def run_open_loop(server, patterns, arrivals, *, result_timeout_s: float = 60.0,
                  tick_s: float = 0.002) -> list:
    """Replay `arrivals` against `server`, cycling through `patterns`.

    Open loop: the submit loop sleeps until the next scheduled arrival and
    NEVER waits for a response; requests due in the past are submitted
    immediately with their scheduled time as `t_arrival`. Returns the list
    of `repro_torch.serve.Response` objects (one per arrival, in schedule
    order) after every future resolves."""
    if len(patterns) == 0:
        raise ValueError("need at least one pattern")
    arrivals = np.asarray(arrivals, np.float64)
    futs = []
    t0 = time.perf_counter()
    i, n = 0, len(arrivals)
    while i < n:
        now = time.perf_counter() - t0
        if arrivals[i] <= now:
            futs.append(server.submit(patterns[i % len(patterns)],
                                      t_arrival=t0 + arrivals[i]))
            i += 1
        else:
            time.sleep(min(arrivals[i] - now, tick_s))
    deadline = time.perf_counter() + result_timeout_s
    return [f.result(timeout=max(deadline - time.perf_counter(), 0.001))
            for f in futs]


def summarize(responses, duration_s: float) -> dict:
    """Fold one open-loop run into a JSON-ready record.

    Latency percentiles cover *accepted-and-served* ("ok") requests only
    — that is the population the SLO is promised to; rejected requests
    are counted, not averaged in (their retry cost is the client's,
    bounded by the retry-after hint). Percentiles are None when nothing
    completed (absent, never a fake 0)."""
    statuses = [r.status for r in responses]
    ok_total = np.asarray([r.total_us for r in responses if r.ok], np.float64)
    ok_queue = np.asarray([r.queue_us for r in responses if r.ok], np.float64)
    out = {
        "offered": len(responses),
        "ok": statuses.count("ok"),
        "rejected": statuses.count("rejected"),
        "shed": statuses.count("shed"),
        "goodput_qps": statuses.count("ok") / max(duration_s, 1e-9),
    }
    if ok_total.size:
        p = np.percentile(ok_total, [50, 95, 99])
        out.update(p50_ms=float(p[0]) * 1e-3, p95_ms=float(p[1]) * 1e-3,
                   p99_ms=float(p[2]) * 1e-3,
                   queue_p99_ms=float(np.percentile(ok_queue, 99)) * 1e-3,
                   max_ms=float(ok_total.max()) * 1e-3)
    else:
        out.update(p50_ms=None, p95_ms=None, p99_ms=None,
                   queue_p99_ms=None, max_ms=None)
    return out
