"""The traced window: `torch.profiler` over a part of a run's window
that the driver chooses, reduced to one record that the per-layer
readers take their numbers from.

The window is a user span, ``sabench.window``, from `begin` to `end`; its
ends bound every device interval. Device time is the union of the kernel,
copy and set intervals inside it, so work that overlaps on two streams
counts once. Host synchronisations are the runtime's
``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` /
``cudaEventSynchronize`` calls inside it, less the benchmark's own (one a
build). Each idle gap of the device is named by the innermost host event
that covers its middle: what the host was doing while the device waited.
"""
from __future__ import annotations

import bisect
import collections

import torch

from .stats import idle_gaps, merged_intervals

SPAN_PREFIX = "sabench."
WINDOW_SPAN = SPAN_PREFIX + "window"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
GAPS_NAMED = 500
NAME_CHARS = 160


class Tracer:
    """Profiles from `begin` until `end`. Disabled, every call does
    nothing and `record` is None."""

    def __init__(self, enabled: bool, device):
        self.enabled = bool(enabled)
        self.device = torch.device(device)
        self.units = 0                   # builds inside
        self.own_syncs = 0
        self._prof = self._span = None
        self.done = False

    @property
    def active(self) -> bool:
        return self._prof is not None and not self.done

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def warm(self) -> None:
        """Start and stop the profiler once at set-up: its first start
        stalls the host for a second or more."""
        if self.enabled:
            with self._profile():
                torch.ones(1, device=self.device).add_(1).cpu()

    def begin(self) -> None:
        if not self.enabled:
            return
        self._prof = self._profile()
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def tick(self, units: int = 0, own_syncs: int = 0) -> None:
        """Count `units` of work and the benchmark's own syncs done while
        the profiler runs."""
        if self.active:
            self.units += units
            self.own_syncs += own_syncs

    def end(self) -> None:
        if not self.active:
            return
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.done = True

    def record(self) -> dict | None:
        """The traced window reduced to numbers (seconds), or None."""
        if self._prof is None:
            return None
        self.end()
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             self.units, self.own_syncs)


def reduce_events(events, units: int, own_syncs: int) -> dict:
    """Busy and window seconds, kernels, host syncs, device time by
    operation and idle time by host activity over the window span."""
    device, host, syncs = [], [], []
    lo = hi = None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):   # the spans' device view
                device.append((start, end, name))
        elif name == WINDOW_SPAN:
            lo, hi = start, end
        else:
            host.append((start, end, name))
            if name in SYNC_CALLS:
                syncs.append(start)
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    inside = [(s, e, n) for s, e, n in device if lo <= s < hi]
    merged = merged_intervals([(s, e) for s, e, _ in device], lo, hi)
    by_op = collections.Counter()
    for s, e, n in inside:
        by_op[n] += (min(e, hi) - s) / 1e9
    gaps = sorted(idle_gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    by_host = collections.Counter()
    host.sort()
    starts = [s for s, _, _ in host]
    for g_start, g_end in gaps[:GAPS_NAMED]:
        by_host[host_at(host, starts, (g_start + g_end) / 2)] += \
            (g_end - g_start) / 1e9
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in merged) / 1e9,
        "kernels": sum(1 for _, _, n in inside
                       if not n.startswith(NOT_KERNELS)),
        "syncs": sum(1 for s in syncs if lo <= s < hi) - own_syncs,
        "units": units,
        "device_ops": [[n[:NAME_CHARS], v]
                       for n, v in by_op.most_common(TOP)],
        "idle_gaps": [[n[:NAME_CHARS], v]
                      for n, v in by_host.most_common(TOP)],
    }


def host_at(host, starts, t, reach: int = 4096) -> str:
    """The innermost host event (latest start) that covers time t, looked
    for among the `reach` events that began last before t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "no traced host call"
