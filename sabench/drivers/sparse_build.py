"""Traffic kind "sparse_build": builds of a sampled index back to back.

Set-up, window and release are those of the "build" kind
(`drivers/build.py`, loaded from its file): `SuffixArrayIndex.from_docs`
of the set-up's documents in a new order each build, with the
configuration's plan, whose `sample_rate` makes it a sparse index. The
record keeps the build kind, so the device-trace readers read it.

The judge compares each sampled build's suffix array with
`reference_sparse.sparse_suffix_array` of that build's text: the dense
reference kept at the sampled positions. The control does the same with
the documents' separators shared.

Around the window this kind takes the difference of the program's
counter snapshots (`repro_torch.trace.counters`), per build, into
``counters_per_build``; a program without them leaves the key out. In a
traced run it joins the program's spans to the traced build's device
intervals (`sabench.spans.span_table`) into ``span_table``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from sabench import corpus, harness, reference, reference_sparse, spans

BUILD = harness.load_module(Path(__file__).with_name("build.py"))
CHECK_BUILDS = BUILD.CHECK_BUILDS
setup, release = BUILD.setup, BUILD.release


def program_counters() -> dict | None:
    """The program's counter snapshot, or None where it keeps none."""
    try:
        from repro_torch.trace import counters
    except ImportError:
        return None
    return counters()


def window(state: dict, seconds: float, tracer) -> dict:
    before = program_counters()
    record = BUILD.window(state, seconds, tracer)
    after = program_counters()
    builds = len(record["builds"])
    if before is not None and builds:
        record["counters_per_build"] = {
            name: (total - before.get(name, 0)) / builds
            for name, total in after.items()}
    if tracer.done:
        table = spans.span_table(
            tracer._prof.profiler.kineto_results.events())
        record["span_table"] = table
        print(spans.format_table(table), file=sys.stderr)
    return record


def _sample_rate(cell) -> int:
    return int(cell.config["plan"]["sample_rate"])


def judge(state: dict, record: dict) -> list:
    """(name, value, limit) of each number compared: positions of the
    sampled builds' sparse suffix arrays that differ from the reference's,
    and the builds that raised."""
    data, cell = state["corpus"], state["cell"]
    s = _sample_rate(cell)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    wrong, kept = 0, state.pop("kept")
    while kept:
        k, sa = kept.pop()
        order = corpus.build_order(cell.seed, k, data.n_docs)
        text = reference.encode(data.data, data.lengths, order)
        want = reference_sparse.sparse_suffix_array(text, s)
        del text
        if sa.shape != want.shape:
            wrong += want.numel()
        else:
            wrong += int((sa.to(want.device, torch.int64) != want).sum())
        del want, sa
    if cell.device.type == "cuda":
        print(f"judge: device peak "
              f"{torch.cuda.max_memory_allocated(cell.device)} B",
              file=sys.stderr)
    return [("sa_positions_wrong", wrong, 0),
            ("builds_failed", record["failed"], 0)]


def control(state: dict) -> list:
    """The control in the program's place: every sampled build's sparse
    suffix array worked out by the reference with the documents'
    separators shared, which lets suffix comparisons run on across a
    boundary."""
    data, cell = state["corpus"], state["cell"]
    s = _sample_rate(cell)
    state["kept"] = [
        (k, reference_sparse.sparse_suffix_array(reference.encode(
            data.data, data.lengths,
            corpus.build_order(cell.seed, k, data.n_docs),
            separators="shared"), s))
        for k, _ in state["kept"]]
    return judge(state, {"failed": 0})
