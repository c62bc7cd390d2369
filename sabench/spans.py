"""The program's spans joined to the device trace of a traced window.

The program marks its layers with spans named ``repro_torch.*``
(`repro_torch.trace.span`); the benchmark's own are ``sabench.*``. Both
are host events of the kineto trace that `sabench.trace.Tracer` takes,
on the clock of the device's intervals. `span_table` gives each span
name of the window:

- ``calls``: its spans; ``host_s``: the union of their intervals;
  ``self_host_s``: the part of it where no other span of the table runs
  inside it;
- ``device_s``: the union, clipped to the window, of the device
  intervals (kernels, copies, sets) launched anywhere under it, child
  spans included. An interval is paired with the runtime call that
  launched it by their CUPTI correlation id, and counts once for each
  name on the chain of spans that covers the call's start, even where a
  name nests in itself (``repro_torch.dcv.level``);
- ``idle_s``: the device's idle gaps whose middle it is the innermost
  span of.

``unattributed_device_s`` is the union of the device intervals with no
matching runtime call or launched outside every program span. Kineto's
device view of a user annotation (a ``gpu_user_annotation``, such as
``sabench.from_docs``'s) spans the kernels it covers and is left out by
its kind. The spans of one window are taken to nest: the build path runs
on one thread.

    python3 sabench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and window traced as ``sabench/run.py --trace 1``
does (no judge), prints the table to standard error and one JSON object
as the last line of standard output: the trace record with ``spans`` and
``unattributed_device_s`` beside its keys, and the seconds of each
window build (build 1 is the traced one; build 2 also holds the
profiler's stop).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("repro_torch.", "sabench.")
PROGRAM = "repro_torch."
WINDOW_SPAN = "sabench.window"
RUNTIME = "cu"              # CUDA runtime (cuda*) and driver (cu*) calls


def span_table(events) -> dict:
    """``{"spans": {name: {...}}, "unattributed_device_s": s}`` over the
    window span of `events` (kineto events, or objects with the same
    methods)."""
    from sabench.stats import idle_gaps, merged_intervals
    spans, device, launch = [], [], {}
    lo = hi = None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id()))
        elif name.startswith(RUNTIME):
            launch[e.correlation_id()] = start
        elif name.startswith(PREFIXES):
            spans.append((start, end, name))
            if name == WINDOW_SPAN:
                lo, hi = start, end
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    spans = sorted(((max(s, lo), min(e, hi), n) for s, e, n in spans
                    if min(e, hi) > max(s, lo)),
                   key=lambda x: (x[0], -x[1]))

    # the chain of spans over each launch and each idle gap's middle
    merged = merged_intervals([(s, e) for s, e, _ in device], lo, hi)
    gaps = idle_gaps(merged, lo, hi)
    points = [launch[c] for _, _, c in device if c in launch]
    points += [(a + b) / 2 for a, b in gaps]
    chains, self_ns = _sweep(spans, points)

    under = collections.defaultdict(list)
    unattributed = []
    for s, e, c in device:
        chain = chains.get(launch.get(c), ())
        if not any(n.startswith(PROGRAM) for n in chain):
            unattributed.append((s, e))
        for n in set(chain):
            under[n].append((s, e))
    idle = collections.Counter()
    for a, b in gaps:            # the window span covers every gap
        idle[chains[(a + b) / 2][-1]] += b - a

    by_name = collections.defaultdict(list)
    for s, e, n in spans:
        by_name[n].append((s, e))

    def union_s(intervals) -> float:
        return sum(e - s for s, e in merged_intervals(intervals, lo, hi)) \
            / 1e9

    table = {n: {"calls": len(iv), "host_s": union_s(iv),
                 "self_host_s": self_ns[n] / 1e9,
                 "device_s": union_s(under[n]), "idle_s": idle[n] / 1e9}
             for n, iv in by_name.items()}
    return {"spans": table, "unattributed_device_s": union_s(unattributed)}


def _sweep(spans, points):
    """({point: names of the spans covering it, outermost first}, {name:
    ns where it is the innermost span}) for spans sorted by (start,
    -end) that nest."""
    chains, own = {}, collections.Counter()
    stack, now = [], 0              # open spans (end, name), innermost last

    def close(t):
        nonlocal now
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            own[name] += end - now
            now = end

    def at(t):
        close(t)
        chains[t] = tuple(name for _, name in stack)

    queries = sorted(set(points))
    q = 0
    for start, end, name in spans:
        while q < len(queries) and queries[q] < start:
            at(queries[q])
            q += 1
        close(start)
        if stack:
            own[stack[-1][1]] += start - now
        now = start
        stack.append((end, name))
    for t in queries[q:]:
        at(t)
    close(float("inf"))
    return chains, own


def format_table(record: dict) -> str:
    """The span table as text, the longest device time first."""
    rows = sorted(record["spans"].items(),
                  key=lambda kv: (-kv[1]["device_s"], -kv[1]["host_s"]))
    out = [f"{'span':36} {'calls':>6} {'host ms':>10} {'self ms':>10} "
           f"{'device ms':>10} {'idle ms':>10}"]
    for name, r in rows:
        out.append(f"{name:36} {r['calls']:6d} {1e3 * r['host_s']:10.3f} "
                   f"{1e3 * r['self_host_s']:10.3f} "
                   f"{1e3 * r['device_s']:10.3f} {1e3 * r['idle_s']:10.3f}")
    out.append(f"unattributed device ms "
               f"{1e3 * record['unattributed_device_s']:.3f}")
    return "\n".join(out)


def trace_cell(name: str, seed: int, seconds: float, device,
               root: Path = ROOT) -> dict:
    """One cell's set-up and window with the tracer on: the trace record
    with the span table beside its keys, and each window build's
    seconds."""
    from sabench import harness
    from sabench.trace import Tracer

    class SpanTracer(Tracer):
        def record(self):
            rec = super().record()
            if rec is not None:
                rec.update(span_table(
                    self._prof.profiler.kineto_results.events()))
            return rec

    cell, driver = harness.resolve(name, seed, seconds, True, device, root)
    tracer = SpanTracer(True, cell.device)
    harness.load_kernels(cell.device)
    state = driver.setup(cell)
    tracer.warm()
    window = driver.window(state, cell.seconds, tracer)
    driver.release(state)
    ends = [window["t_start"]] + [t for _, t in window["builds"]]
    return {"workload": name, "seed": seed,
            "device": harness.device_info(cell.device),
            "build_s": [b - a for a, b in zip(ends, ends[1:])],
            "trace": tracer.record()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    out = trace_cell(args.workload, args.seed, args.seconds, "cuda")
    print(format_table(out["trace"]), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
