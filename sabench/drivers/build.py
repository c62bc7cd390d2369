"""Traffic kind "build": `SuffixArrayIndex.from_docs` builds back to back.

Set-up makes the configuration's corpus from the seed and warms the plan
with one build of it. The window's build k takes the same
documents in an order drawn from the seed and k, so no two builds index
the same text and none can be answered from a cache of results. Each
build ends in a device synchronise; the window closes at the end of the
first build that ends `seconds` after it opened.

A sample of the window's builds, `CHECK_BUILDS` of them drawn from the
seed by reservoir sampling while the window runs, keeps its suffix array;
after the window the reference works out each one's text and suffix array
again from the documents and the order, and every position is compared.

A traced run profiles build 1 alone, from the end of build 0 to its own
end: the window's first build runs slower than the rest.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from sabench import corpus, reference

#: window builds whose suffix arrays are judged
CHECK_BUILDS = 3
#: the window build the profiler sees in a traced run
TRACED = 1


def plan(config: dict, device):
    """The configuration's `SAOptions`: the plan's fields as written, a
    mesh of `mesh_ranks` ranks when one is given, and a superstep counter
    on a mesh."""
    from repro_torch.api import SAOptions
    fields = dict(config.get("plan", {}))
    ranks = config.get("mesh_ranks")
    if ranks:
        from repro_torch.bsp.counters import BSPCounters
        from repro_torch.launch.mesh import make_sa_mesh
        fields["mesh"] = make_sa_mesh(int(ranks), device=str(device))
        fields["counters"] = BSPCounters()
    return SAOptions(**fields)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell) -> dict:
    from repro_torch.api import SuffixArrayIndex
    dev = cell.device
    t0 = time.perf_counter()
    data = corpus.make_corpus(cell.config, cell.seed, dev)
    print(f"corpus {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    opts = plan(cell.config, dev)
    t0 = time.perf_counter()
    SuffixArrayIndex.from_docs(data.docs, opts, device=dev)
    sync(dev)
    print(f"warm build {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return {"cell": cell, "corpus": data, "options": opts}


def window(state: dict, seconds: float, tracer) -> dict:
    from repro_torch.api import SuffixArrayIndex
    cell, data, opts = state["cell"], state["corpus"], state["options"]
    dev = cell.device
    counters = opts.counters
    pick = np.random.default_rng([cell.seed % (2 ** 63), 1])
    kept, builds, supersteps, failed = [], [], [], 0
    sync(dev)
    t_start = time.perf_counter()
    k = 0
    while True:
        with torch.profiler.record_function("sabench.order"):
            docs = data.docs[corpus.build_order(cell.seed, k, data.n_docs)]
        before = counters.supersteps if counters is not None else 0
        try:
            with torch.profiler.record_function("sabench.from_docs"):
                index = SuffixArrayIndex.from_docs(docs, opts, device=dev)
            sync(dev)
        except Exception:                 # a build that never comes
            traceback.print_exc(file=sys.stderr)
            failed += 1
            break
        t_end = time.perf_counter()
        print(f"build {k} ends at {t_end - t_start:.3f} s", file=sys.stderr)
        builds.append((data.tokens, t_end))
        if counters is not None:
            supersteps.append(counters.supersteps - before)
        # reservoir sampling: every build of the window is equally likely
        # to be among the CHECK_BUILDS whose suffix arrays are judged
        if len(kept) < CHECK_BUILDS:
            kept.append((k, index.sa))
        else:
            slot = int(pick.integers(0, k + 1))
            if slot < CHECK_BUILDS:
                kept[slot] = (k, index.sa)
        del index
        tracer.tick(units=1, own_syncs=int(dev.type == "cuda"))
        k += 1
        if k == TRACED:
            tracer.begin()
            print(f"trace begins at build {k}", file=sys.stderr)
        elif k == TRACED + 1:
            tracer.end()
        # a traced run's window holds the traced build
        if t_end - t_start >= seconds and not tracer.active:
            break
    tracer.end()
    state["kept"] = kept
    return {"kind": "build", "t_start": t_start, "builds": builds,
            "supersteps": supersteps, "attempted": k + failed,
            "failed": failed}


def release(state: dict) -> None:
    """Drop the program's objects; the sampled suffix arrays stay."""
    state.pop("options", None)
    if state["cell"].device.type == "cuda":
        torch.cuda.empty_cache()


def judge(state: dict, record: dict) -> list:
    """(name, value, limit) of each number compared: positions of the
    sampled suffix arrays that differ from the reference's, and the
    builds that raised."""
    data, cell = state["corpus"], state["cell"]
    wrong, kept = 0, state.pop("kept")
    while kept:
        k, sa = kept.pop()
        order = corpus.build_order(cell.seed, k, data.n_docs)
        text = reference.encode(data.data, data.lengths, order)
        want = reference.suffix_array(text)
        del text
        if sa.shape != want.shape:
            wrong += want.numel()
        else:
            wrong += int((sa.to(want.device, torch.int64) != want).sum())
        del want, sa
    return [("sa_positions_wrong", wrong, 0),
            ("builds_failed", record["failed"], 0)]


def control(state: dict) -> list:
    """The control in the program's place: every sampled build's suffix
    array worked out by the reference with the documents' separators
    shared, which lets suffix comparisons run on across a boundary."""
    data, cell = state["corpus"], state["cell"]
    state["kept"] = [
        (k, reference.suffix_array(reference.encode(
            data.data, data.lengths,
            corpus.build_order(cell.seed, k, data.n_docs),
            separators="shared")))
        for k, _ in state["kept"]]
    return judge(state, {"failed": 0})
