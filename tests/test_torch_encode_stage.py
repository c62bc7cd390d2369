"""The staged corpus layout of `SuffixArrayIndex.from_docs`
(`api.index.stage_docs`: one concatenate into a staging buffer, then
`ops.encode_place` on the device) held bit for bit to the per-document
encode loop that it replaced, which is written out here as the reference;
`kernels.ref.encode_place_ref` to a direct numpy layout; the two
`ValueError`s and the `repro_torch.index.docs_converted` counter.

CPU only and JAX-free; the CUDA kernel is held to its plain version in
`tests/test_torch_gpu.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import encode_docs
from repro_torch.api.index import stage_docs
from repro_torch.kernels import ops, ref
from repro_torch.trace import counters

SEED = 20261018
CONVERTED = "repro_torch.index.docs_converted"


def loop_encode(docs):
    """The encode as the JAX package and the port wrote it before staging:
    one shifted copy and one separator array a document."""
    n_docs = len(docs)
    if n_docs == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    parts, starts, off = [], [], 0
    for i, d in enumerate(docs):
        d = np.asarray(d, np.int64)
        if d.ndim != 1:
            raise ValueError(f"doc {i} must be 1-D, got shape {d.shape}")
        if len(d) and int(d.min()) < 0:
            raise ValueError(f"doc {i} has negative values")
        starts.append(off)
        parts.append(d + n_docs)
        parts.append(np.asarray([i], np.int64))
        off += len(d) + 1
    return np.concatenate(parts), np.asarray(starts, np.int64), n_docs


def _ragged(seed, n_docs, hi=50, empty_share=0.2, dtype=np.int64):
    rng = np.random.default_rng([SEED, seed])
    lengths = rng.integers(1, 40, n_docs)
    lengths[rng.random(n_docs) < empty_share] = 0
    return [rng.integers(0, hi, n).astype(dtype) for n in lengths]


def _object_array(docs):
    out = np.empty(len(docs), dtype=object)
    out[:] = docs
    return out


CASES = {
    "no_docs": [],
    "one_empty_doc": [np.zeros(0, np.int64)],
    "empty_docs": [np.zeros(0, np.int64)] * 3 + [np.arange(3)],
    "one_doc": [np.arange(7) % 3],
    "int64": _ragged(1, 60),
    "int32": _ragged(2, 60, dtype=np.int32),
    "uint8": _ragged(3, 20, dtype=np.uint8),
    "lists": [list(range(5)), [], [4, 4, 1]],
    "mixed": [np.arange(4, dtype=np.int16), [2.0, 1.0], np.arange(3)],
    "object_array": _object_array(_ragged(4, 30)),
    "rows_of_a_matrix": np.arange(24).reshape(4, 6),
}


def _assert_same(got, want):
    text, starts, n_docs = got
    assert isinstance(text, np.ndarray) and text.dtype == np.int64
    assert starts.dtype == np.int64 and n_docs == want[2]
    np.testing.assert_array_equal(text, want[0])
    np.testing.assert_array_equal(starts, want[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_layout_equals_the_loop(case):
    docs = CASES[case]
    want = loop_encode(docs)
    _assert_same(encode_docs(docs), want)
    text, starts, n_docs = stage_docs(docs, "cpu")
    assert text.dtype == torch.int64
    _assert_same((text.numpy(), starts, n_docs), want)


@pytest.mark.parametrize("seed", range(3))
def test_permuted_orders_equal_the_loop(seed):
    docs = _object_array(_ragged(10, 200))
    order = np.random.default_rng([SEED, seed]).permutation(len(docs))
    _assert_same(encode_docs(docs[order]), loop_encode(docs[order]))


def test_a_smaller_corpus_after_a_larger_leaves_no_stale_tail():
    large, small = _ragged(20, 300, hi=1000), _ragged(21, 40, hi=5)
    for docs in (large, small, large[:7]):
        _assert_same(encode_docs(docs), loop_encode(docs))


@pytest.mark.parametrize("seed", range(3))
def test_encode_place_ref_is_the_direct_layout(seed):
    rng = np.random.default_rng([SEED, 30 + seed])
    docs = _ragged(30 + seed, 500, hi=9, empty_share=0.3)
    flat = np.concatenate(docs)
    ends = np.cumsum([len(d) for d in docs])
    flat[rng.integers(0, len(flat))] *= -1 if seed else 0
    text, negative = ref.encode_place_ref(torch.from_numpy(flat),
                                          torch.from_numpy(ends))
    # np.insert puts value k before original index ends[k], in the order
    # given where ends repeat: right after document k's last token
    np.testing.assert_array_equal(
        text.numpy(), np.insert(flat + len(docs), ends, np.arange(len(docs))))
    assert negative.dtype == torch.int32 and negative.shape == (1,)
    assert int(negative) == int((flat < 0).any())
    got = ops.encode_place(torch.from_numpy(flat), torch.from_numpy(ends))
    assert all(torch.equal(g, w) for g, w in zip(got, (text, negative)))


@pytest.mark.parametrize("at", [0, 3, 9])
@pytest.mark.parametrize("fault", ["2-D", "0-D", "negative", "negative list"])
def test_errors_name_the_document_the_loop_names(at, fault):
    docs = _ragged(40, 10, empty_share=0.0)
    docs[at] = {"2-D": np.zeros((2, 2), np.int64), "0-D": np.array(5),
                "negative": np.array([3, -1, 2]),
                "negative list": [0, 1, -7]}[fault]
    with pytest.raises(ValueError) as want:
        loop_encode(docs)
    assert f"doc {at} " in str(want.value)
    for stage in (encode_docs, lambda d: stage_docs(d, "cpu")):
        with pytest.raises(ValueError) as got:
            stage(docs)
        assert str(got.value) == str(want.value)


def test_docs_converted_counts_only_documents_that_are_not_integer_arrays():
    def converted(docs):
        before = counters().get(CONVERTED, 0)
        encode_docs(docs)
        return counters()[CONVERTED] - before

    ints = _ragged(50, 20, empty_share=0.0)
    assert converted(ints) == 0
    assert converted(_ragged(51, 20, dtype=np.int32)) == 0
    assert converted(_object_array(ints)) == 0
    assert converted(ints[:5] + [[1, 2], np.array([1.0, 3.0]),
                                 np.array([True])]) == 3
    assert converted([list(d) for d in ints]) == len(ints)
