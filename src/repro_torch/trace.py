"""Named spans at the layer boundaries of the build path.

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
"""
from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` while the profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)
