"""Traffic kind "collection_build": builds of a genome collection back to
back.

Set-up makes the configuration's collection from the seed
(`sabench.collection`) and warms the plan with one build of it. The
window, release, judge and control are those of the "build" kind
(`drivers/build.py`, loaded from its file): `SuffixArrayIndex.from_docs`
of the strains in a new order each build, with the configuration's plan;
3 reservoir-sampled builds are judged against `sabench/reference.py`. The
record keeps the build kind, so the device-trace readers read it.

The window is wrapped as the "sparse_build" kind wraps it
(`drivers/sparse_build.py`'s `window`): the difference of the program's
counter snapshots, per build, into ``counters_per_build``, and in a
traced run the span table of the traced build into ``span_table``,
printed to standard error.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

from sabench import collection, harness

HERE = Path(__file__).parent
BUILD = harness.load_module(HERE / "build.py")
window = harness.load_module(HERE / "sparse_build.py").window
release, judge, control = BUILD.release, BUILD.judge, BUILD.control


def setup(cell) -> dict:
    from repro_torch.api import SuffixArrayIndex
    dev = cell.device
    t0 = time.perf_counter()
    data = collection.make_collection(cell.config, cell.seed, dev)
    print(f"collection {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    opts = BUILD.plan(cell.config, dev)
    t0 = time.perf_counter()
    SuffixArrayIndex.from_docs(data.docs, opts, device=dev)
    BUILD.sync(dev)
    print(f"warm build {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return {"cell": cell, "corpus": data, "options": opts}
