"""Named spans at the layer boundaries of the build path, and counters.

`span(name)` marks a region for `torch.profiler`: with the profiler on,
the region is a host event named `name` in the same kineto trace, on the
same clock, as the device's kernels, so a reader of the trace can give
each kernel to the spans that launched it. With the profiler off it is
one shared null context, and a span costs a call and a flag read.

The span is a plain operator-scope record function, not a user
annotation: kineto copies every user annotation onto the device timeline
as a `gpu_user_annotation` interval, which a reader that unions the
device's intervals would take for work. Every name starts with
``repro_torch.``.

`count(name, n)` adds to a process-wide counter, whether or not the
profiler runs; it adds host integers the caller already holds and reads
nothing from the device. `counters()` is a snapshot: a reader takes the
difference of two.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()      # count() may run on any thread


def span(name: str):
    """A context manager that records `name` while the profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (a host integer, no device read)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter: name -> total since the process
    started."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)
