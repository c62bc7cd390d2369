"""The port's spans (`repro_torch.trace.span`) on the build path, on the
CPU: their names and nesting under `torch.profiler`, one
`repro_torch.mesh.collective` span a rendezvous of Algorithm 3's mesh,
no scan op under `repro_torch.bsp.group_index`, no record function
entered with the profiler off, and suffix arrays equal to the JAX
package's oracle either way."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.trace
from repro.core.oracle import suffix_array_doubling
from repro_torch.api import SAOptions, SuffixArrayIndex, encode_docs
from repro_torch.bsp import within_group_index
from repro_torch.bsp.counters import BSPCounters
from repro_torch.launch.mesh import make_sa_mesh


def corpus(seed=0, n_docs=40):
    """Documents over 4 letters: the DC-v recursion takes two levels."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=int(rng.integers(20, 200)))
            for _ in range(n_docs)]


def oracle_sa(docs):
    return suffix_array_doubling(encode_docs(docs)[0])


def program_spans(prof):
    """(start, end, name) of the program's spans, in start order."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("repro_torch."))


def parents(spans):
    """Each span's innermost enclosing span name (None at the top)."""
    out = []
    for i, (s, e, name) in enumerate(spans):
        up = [x for x in spans[:i] if x[0] <= s and e <= x[1]]
        out.append((name, up[-1][2] if up else None))
    return out


def traced(build):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = build()
    return out, prof


def test_build_spans_nest_by_layer():
    docs = corpus()
    index, prof = traced(
        lambda: SuffixArrayIndex.from_docs(docs, device="cpu"))
    np.testing.assert_array_equal(index.sa.numpy(), oracle_sa(docs))
    spans = program_spans(prof)
    names = [n for _, _, n in spans]
    assert names[:3] == ["repro_torch.index.encode_docs",
                         "repro_torch.index.upload", "repro_torch.build"]
    assert spans[0][1] <= spans[1][0] and spans[1][1] <= spans[2][0]
    links = collections.Counter(parents(spans))
    assert links[("repro_torch.dcv.level", "repro_torch.build")] == 1
    assert links[("repro_torch.dcv.level", "repro_torch.dcv.level")] >= 1
    for step in ("window_order", "sample_rank", "resolve_ties"):
        name = f"repro_torch.dcv.{step}"
        assert {p for n, p in links if n == name} == \
            {"repro_torch.dcv.level"}, name
        assert names.count(name) == names.count("repro_torch.dcv.level")
    assert {p for n, p in links if n == "repro_torch.dcv.refine"} == \
        {"repro_torch.dcv.resolve_ties"}


def test_spans_are_not_user_annotations():
    """Kineto copies a user annotation onto the device timeline, where
    the benchmark's trace reader would count it as a kernel. Read with
    the methods every supported torch's kineto event has."""
    _, prof = traced(lambda: SuffixArrayIndex.from_docs(corpus(1),
                                                        device="cpu"))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro_torch.")]
    assert events
    assert {e.device_type() for e in events} == \
        {torch.autograd.DeviceType.CPU}
    assert not any(e.is_user_annotation() for e in events)


def test_mesh_collective_spans_equal_rendezvous():
    docs = corpus(2, n_docs=12)
    mesh = make_sa_mesh(8, device="cpu")
    counters = BSPCounters()
    index, prof = traced(lambda: SuffixArrayIndex.from_docs(
        docs, SAOptions(mesh=mesh, counters=counters), device="cpu"))
    np.testing.assert_array_equal(index.sa.numpy(), oracle_sa(docs))
    count = collections.Counter(n for _, _, n in program_spans(prof))
    assert mesh.rendezvous > 0
    assert count["repro_torch.mesh.collective"] == mesh.rendezvous
    assert count["repro_torch.mesh.local"] > mesh.rendezvous
    assert count["repro_torch.bsp.group_index"] > 0
    assert count["repro_torch.bsp.sm1"] == count["repro_torch.bsp.sm2"] \
        == counters.rounds > 0


def test_group_index_runs_no_scan():
    """`within_group_index` finds its run starts with `core.words.run_starts`:
    no running maximum or minimum (a scan in series on the card), and one
    `repro_torch.bsp.group_index` span a call."""
    rng = np.random.default_rng(5)
    calls = [(torch.from_numpy(rng.integers(0, 9, m)),
              torch.from_numpy(rng.random(m) > 0.1)) for m in (0, 1, 4096)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for group, valid in calls:
            within_group_index(group, valid)
    ops = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not ops & {"aten::cummax", "aten::cummin", "aten::_cummax_helper",
                      "aten::_cummin_helper"}
    assert "aten::cumsum" in ops
    count = collections.Counter(n for _, _, n in program_spans(prof))
    assert count["repro_torch.bsp.group_index"] == len(calls)


def test_profiler_off_enters_no_record_function(monkeypatch):
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(repro_torch.trace, "_RecordFunctionFast", counting)
    assert not torch.autograd._profiler_enabled()
    docs = corpus(3, n_docs=12)
    dense = SuffixArrayIndex.from_docs(docs, device="cpu")
    mesh = make_sa_mesh(8, device="cpu")
    bsp = SuffixArrayIndex.from_docs(docs, SAOptions(mesh=mesh),
                                     device="cpu")
    assert entered == [] and mesh.rendezvous > 0
    want = oracle_sa(docs)
    np.testing.assert_array_equal(dense.sa.numpy(), want)
    np.testing.assert_array_equal(bsp.sa.numpy(), want)


@pytest.mark.parametrize("sort_impl", ["torch", "radix", "bitonic"])
def test_every_sort_impl_spans_its_levels(sort_impl):
    docs = corpus(4, n_docs=10)
    index, prof = traced(lambda: SuffixArrayIndex.from_docs(
        docs, SAOptions(sort_impl=sort_impl), device="cpu"))
    np.testing.assert_array_equal(index.sa.numpy(), oracle_sa(docs))
    count = collections.Counter(n for _, _, n in program_spans(prof))
    assert count["repro_torch.dcv.level"] >= 1
    # the legacy bitonic path spans its levels alone: no cell runs it
    steps = 0 if sort_impl == "bitonic" else count["repro_torch.dcv.level"]
    assert count["repro_torch.dcv.sample_rank"] == steps
    assert count["repro_torch.dcv.resolve_ties"] == steps
