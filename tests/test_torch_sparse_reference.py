"""The port's sampled index (`SAOptions(sample_rate=s)`) on the CPU held
to the benchmark's plain sparse reference (`sabench.reference_sparse`:
the dense prefix-doubling suffix array kept at the sampled positions), on
the benchmark's own corpora; and the sparse construction's spans and
counters (`repro_torch.trace`), the counters against tie rounds worked
out from the reference's order."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.trace
from repro_torch.api import SAOptions, SuffixArrayIndex
from sabench import corpus, reference
from sabench.reference_sparse import sparse_suffix_array


def make_corpus(vocab, tokens, seed):
    config = {"tokens": tokens,
              "corpus": {"vocab": vocab, "zipf_exponent": 1.0,
                         "doc_length": {"dist": "lognormal", "mean": 64,
                                        "sigma": 1.0},
                         "copy_share": 0.2, "passage": [16, 96]}}
    return corpus.make_corpus(config, seed, "cpu")


def sparse_index(docs, s):
    return SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=s),
                                      device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [2, 3, 16, 32])
@pytest.mark.parametrize("vocab", [16, 32000])
def test_sparse_from_docs_equals_the_plain_reference(vocab, rate, seed):
    data = make_corpus(vocab, 2 ** (12 + seed), 2 ** 31 + 101 * seed)
    index = sparse_index(data.docs, rate)
    want = sparse_suffix_array(reference.encode(data.data, data.lengths),
                               rate)
    assert index.sa.dtype == torch.int32
    assert torch.equal(index.sa.long(), want)


EDGES = {
    # 5 + 7 + 2 separators: n = 14, not a multiple of 3
    "n_not_a_multiple": ([[1, 2, 1, 2, 1], [2, 1, 2, 1, 2, 1, 2]], 3),
    "one_document": ([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]], 4),
    "all_equal": ([[5] * 200], 16),
    "all_equal_docs": ([[0] * 37, [0] * 64, [0] * 5], 2),
    "shorter_than_the_rate": ([[1, 2]], 32),
}


@pytest.mark.parametrize("entry", ["from_docs", "build"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_texts_equal_the_plain_reference(edge, entry):
    docs, rate = EDGES[edge]
    docs = [np.asarray(d, np.int64) for d in docs]
    if entry == "from_docs":
        index = sparse_index(docs, rate)
        lengths = torch.tensor([len(d) for d in docs])
        text = reference.encode(torch.as_tensor(np.concatenate(docs)),
                                lengths)
    else:
        text = torch.as_tensor(np.concatenate(docs))
        index = SuffixArrayIndex.build(text.numpy(), SAOptions(
            sample_rate=rate), device="cpu")
    assert torch.equal(index.text.long(), text)
    assert torch.equal(index.sa.long(), sparse_suffix_array(text, rate))


def tie_rounds(text, ssa, s):
    """(rounds, tied rows summed) of stride doubling, from the order
    alone: at round h two sampled suffixes are tied while they share
    their first h·s characters, so the round finds the rows of the runs
    of neighbours whose common prefix reaches h·s."""
    text, ssa = text.numpy(), ssa.numpy()
    lcp = np.zeros(len(ssa) + 1, np.int64)     # lcp[k]: rows k-1 and k
    for k in range(1, len(ssa)):
        a, b = text[ssa[k - 1]:], text[ssa[k]:]
        m = min(len(a), len(b))
        differ = np.flatnonzero(a[:m] != b[:m])
        lcp[k] = differ[0] if len(differ) else m
    rounds = rows = 0
    h = 1
    while h < len(ssa):
        tied = (lcp[:-1] >= h * s) | (lcp[1:] >= h * s)
        if not tied.any():
            break
        rounds += 1
        rows += int(tied.sum())
        h *= 2
    return rounds, rows


def spans_of(prof):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("repro_torch."))


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("entry", ["from_docs", "build"])
def test_spans_nest_and_counters_equal_the_tie_rounds(entry):
    data = make_corpus(16, 2 ** 12, 2 ** 31 + 7)
    s = 4
    text = reference.encode(data.data, data.lengths)
    before = repro_torch.trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if entry == "from_docs":
            index = sparse_index(data.docs, s)
        else:
            index = SuffixArrayIndex.build(text.numpy(), SAOptions(
                sample_rate=s), device="cpu")
    after = repro_torch.trace.counters()
    want = sparse_suffix_array(text, s)
    assert torch.equal(index.sa.long(), want)

    rounds, rows = tie_rounds(text, want, s)
    assert rounds >= 2
    assert after["repro_torch.sparse.rounds"] - \
        before.get("repro_torch.sparse.rounds", 0) == rounds
    assert after["repro_torch.sparse.tied_rows"] - \
        before.get("repro_torch.sparse.tied_rows", 0) == rows

    spans = spans_of(prof)
    by_name = collections.defaultdict(list)
    for sp in spans:
        by_name[sp[2]].append(sp)
    (construct,) = by_name["repro_torch.sparse.construct"]
    (heads,) = by_name["repro_torch.sparse.heads"]
    (upload,) = by_name["repro_torch.index.upload"]
    assert len(by_name["repro_torch.sparse.double"]) == rounds
    assert inside(heads, construct)
    assert all(inside(d, construct) and d[0] >= heads[1]
               for d in by_name["repro_torch.sparse.double"])
    # the upload comes after the encode and ends before the construction
    assert upload[1] <= construct[0]
    if entry == "from_docs":
        (encode,) = by_name["repro_torch.index.encode_docs"]
        assert encode[1] <= upload[0]


def test_profiler_off_keeps_the_null_span(monkeypatch):
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(repro_torch.trace, "_RecordFunctionFast", counting)
    assert not torch.autograd._profiler_enabled()
    assert repro_torch.trace.span("repro_torch.sparse.construct") is \
        repro_torch.trace._OFF
    data = make_corpus(16, 2 ** 12, 2 ** 31 + 9)
    index = sparse_index(data.docs, 3)
    assert entered == []
    assert torch.equal(index.sa.long(), sparse_suffix_array(
        reference.encode(data.data, data.lengths), 3))
