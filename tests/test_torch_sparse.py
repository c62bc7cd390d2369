"""The port's sparse sampled-position index (`repro_torch.sparse`) held
against the JAX package's (`repro.sparse`) and against the port's own dense
index, on the CPU (``device="cpu"``: the radix sort runs its kernels'
plain versions).

Inputs are made with numpy from a seed and handed to both packages; every
comparison is on integers and exact (tolerance 0). JAX stays on the CPU
(tests/conftest.py).
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sparse as jsparse
from repro_torch.api import (SAOptions, SuffixArrayIndex, build_suffix_array,
                             longest_match_len)
from repro_torch.sparse import (PatternTooShortError, SparseSuffixArrayIndex,
                                build_sparse_suffix_array, sparse_lcp)
from repro_torch.sparse import construct, query

REPO = Path(__file__).resolve().parent.parent
SEED = 20261017
RATE = 4


def _load_families():
    """`FAMILIES` of tests/api/test_fuzz_differential.py."""
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _load_families()


def _text(family: str, n: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, n, sorted(FAMILIES).index(family)])
    sigma = int(rng.integers(2, 64))
    return np.asarray(FAMILIES[family](rng, n, sigma), np.int64)


def _docs(seed=0, n_docs=5, lo=60, hi=400, sigma=6):
    rng = np.random.default_rng([SEED, seed])
    docs = [rng.integers(0, sigma, int(rng.integers(lo, hi)))
            for _ in range(n_docs)]
    docs.append(np.concatenate([docs[0][10:90], docs[1][:50]]))  # repeats
    return docs


def _patterns(docs, rng, k=40, min_len=RATE):
    pats = []
    for _ in range(k):
        d = docs[int(rng.integers(len(docs)))]
        m = int(rng.integers(min_len, min(40, len(d))))
        a = int(rng.integers(0, len(d) - m + 1))
        pats.append(d[a:a + m])
    half = min_len // 2 + 1
    pats.append(np.full(min_len + 2, 5))       # may be absent
    pats.append(np.concatenate([docs[0][-half:], docs[1][:half]]))  # a sep
    return pats


# ------------------------------------------------------------ construction
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("rate", [2, 3, 4, 16])
def test_sparse_sa_and_lcp_match_jax(family, rate):
    for n in (1, 7, 900):
        x = _text(family, n)
        want = jsparse.build_sparse_suffix_array(x, rate)
        got = build_sparse_suffix_array(x, rate, device="cpu")
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(sparse_lcp(x, got.numpy()),
                                      jsparse.sparse_lcp(x, want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sparse_sa_is_the_dense_sa_restricted(family):
    x = _text(family, 1300)
    dense = build_suffix_array(x, device="cpu").numpy()
    for rate in (2, 5):
        got = build_sparse_suffix_array(torch.from_numpy(x), rate,
                                        device="cpu")
        np.testing.assert_array_equal(got.numpy(), dense[dense % rate == 0])


def test_sparse_build_edge_inputs():
    assert build_sparse_suffix_array([], 4, device="cpu").numel() == 0
    np.testing.assert_array_equal(
        construct.sampled_positions(10, 4), jsparse.construct.
        sampled_positions(10, 4))
    with pytest.raises(ValueError, match="sample_rate"):
        build_sparse_suffix_array(np.arange(8), 1, device="cpu")
    with pytest.raises(ValueError, match="≥ 0"):
        build_sparse_suffix_array([3, -1, 2], 2, device="cpu")


def test_head_words_order_like_the_reference():
    # the port packs ≤ 63 bits a word (the reference packs 64 into uint64);
    # the orders the two word lists give must agree
    x = _text("uniform", 997)
    ns, s = -(-len(x) // 16), 16
    words, widths = construct._sampled_head_words(torch.from_numpy(x), ns, s)
    assert all(0 < b <= 63 for b in widths)
    assert all(int(w.min()) >= 0 and int(w.max()) < 2 ** b
               for w, b in zip(words, widths))
    ref_words = jsparse.construct._sampled_head_words(x, ns, s)
    ours = np.lexsort([w.numpy() for w in reversed(words)])
    theirs = np.lexsort(list(reversed(ref_words)))
    np.testing.assert_array_equal(ours, theirs)


# ------------------------------------------------------- facade dispatch
def test_facade_dispatches_on_sample_rate():
    text = np.arange(40) % 7
    idx = SuffixArrayIndex.build(text, SAOptions(sample_rate=RATE),
                                 device="cpu")
    assert type(idx) is SparseSuffixArrayIndex
    assert idx.sample_rate == RATE and idx.min_pattern_len == RATE
    assert idx.ns == -(-idx.n // RATE) and idx.sep_count == 0
    assert "rate=4" in idx.options.fingerprint()
    dense = SuffixArrayIndex.build(text, device="cpu")
    assert type(dense) is SuffixArrayIndex and dense.min_pattern_len == 0
    docs = _docs()
    sp = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=RATE),
                                    device="cpu")
    assert type(sp) is SparseSuffixArrayIndex
    assert sp.sep_count == len(docs) == sp.n_docs
    assert "SparseSuffixArrayIndex(" in repr(sp)


def test_sparse_index_checks_its_shapes():
    with pytest.raises(ValueError, match="ceil"):
        SparseSuffixArrayIndex(np.arange(10), np.arange(10), sample_rate=2,
                               device="cpu")
    with pytest.raises(ValueError, match="sample_rate"):
        SparseSuffixArrayIndex(np.arange(10), np.arange(10), sample_rate=1,
                               device="cpu")
    with pytest.raises(ValueError, match="sa shape"):
        SuffixArrayIndex(np.arange(10), np.arange(5), device="cpu")


def test_build_suffix_array_rejects_sparse_plan():
    with pytest.raises(ValueError, match="sample_rate"):
        build_suffix_array(np.arange(10), SAOptions(sample_rate=4),
                           device="cpu")
    with pytest.raises(ValueError, match="sample_rate"):
        japi.build_suffix_array(np.arange(10), japi.SAOptions(sample_rate=4))


# -------------------------------------------------------- query parity
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [2, 4, 7])
def test_queries_match_jax_sparse_and_port_dense(seed, rate):
    docs = _docs(seed)
    rng = np.random.default_rng([SEED, seed, rate])
    pats = _patterns(docs, rng, min_len=rate)
    ours = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=rate),
                                      device="cpu")
    theirs = japi.SuffixArrayIndex.from_docs(
        docs, japi.SAOptions(sample_rate=rate))
    dense = SuffixArrayIndex.from_docs(docs, device="cpu")
    np.testing.assert_array_equal(ours.sa.numpy(), theirs.sa)
    counts = ours.count_batch(pats)
    assert counts.dtype == np.int64
    np.testing.assert_array_equal(counts, theirs.count_batch(pats))
    np.testing.assert_array_equal(counts, dense.count_batch(pats))
    np.testing.assert_array_equal(ours.contains_batch(pats),
                                  theirs.contains_batch(pats))
    for a, b, c in zip(ours.locate_batch(pats), theirs.locate_batch(pats),
                       dense.locate_batch(pats)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for a, b in zip(ours.locate_docs_batch(pats),
                    theirs.locate_docs_batch(pats)):
        np.testing.assert_array_equal(a, b)
    assert ours.count(pats[0]) == theirs.count(pats[0])
    np.testing.assert_array_equal(ours.locate(pats[1]), theirs.locate(pats[1]))
    enc = [ours._encode_pattern(p) for p in pats]
    np.testing.assert_array_equal(ours._counts_encoded(enc), counts)
    for a, b in zip(ours._positions_encoded(enc), dense.locate_batch(pats)):
        np.testing.assert_array_equal(a, b)
    for seq in (np.concatenate([docs[2][5:60], [0, 1, 2, 3, 4, 5]]),
                docs[3][:rate - 1], np.full(30, 99)):
        assert ours.longest_match(seq) == theirs.longest_match(seq)


def test_query_batch_split_over_b_keeps_answers(monkeypatch):
    docs = _docs(4)
    idx = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=RATE),
                                     device="cpu")
    pats = _patterns(docs, np.random.default_rng(9), k=60)
    whole = idx.count_batch(pats)
    where = idx.locate_batch(pats)
    monkeypatch.setattr(query, "_MAX_WINDOW", RATE * 2 * 64 * 3)
    np.testing.assert_array_equal(idx.count_batch(pats), whole)
    for a, b in zip(idx.locate_batch(pats), where):
        np.testing.assert_array_equal(a, b)


def test_sparse_lcp_property_matches_jax():
    docs = _docs(5)
    ours = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=3),
                                      device="cpu")
    theirs = japi.SuffixArrayIndex.from_docs(docs,
                                             japi.SAOptions(sample_rate=3))
    np.testing.assert_array_equal(ours.lcp, theirs.lcp)


def test_empty_sparse_index():
    idx = SuffixArrayIndex.build([], SAOptions(sample_rate=RATE),
                                 device="cpu")
    assert idx.ns == 0
    np.testing.assert_array_equal(idx.count_batch([[1, 2, 3, 4]]), [0])
    assert idx.longest_match([1, 2, 3, 4, 5]) == 0


# ------------------------------------------------------ typed refusals
def test_pattern_too_short_is_typed():
    idx = SuffixArrayIndex.build(np.arange(64) % 5,
                                 SAOptions(sample_rate=RATE), device="cpu")
    with pytest.raises(PatternTooShortError) as ei:
        idx.count_batch([[1, 2, 3]])
    assert isinstance(ei.value, ValueError)
    assert (ei.value.pattern_len, ei.value.sample_rate) == (3, RATE)
    for meth in (idx.count, idx.contains_batch, idx.locate_batch,
                 idx.locate_docs_batch):
        with pytest.raises(PatternTooShortError):
            meth([[0] * (RATE - 1)])
    with pytest.raises(PatternTooShortError):
        idx.count([])


@pytest.mark.parametrize("method,arg", [
    ("sa_ranges_batch", [[0, 1, 2, 3]]), ("ngram_stats", 3),
    ("duplicate_spans", 8), ("cross_doc_duplicates", 8)])
def test_dense_only_operations_raise(method, arg):
    idx = SuffixArrayIndex.build(np.arange(64) % 5,
                                 SAOptions(sample_rate=RATE), device="cpu")
    with pytest.raises(NotImplementedError):
        getattr(idx, method)(arg)


@pytest.mark.parametrize("seed", [0, 3])
def test_sparse_staged_path_matches_count_batch(seed):
    """The serving protocol: `stage_encoded` then `ranges_staged` gives
    virtual (0, count) ranges whose widths equal the dense index's and
    the JAX package's counts."""
    docs = _docs(seed)
    idx = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=RATE),
                                     device="cpu")
    ref = japi.SuffixArrayIndex.from_docs(docs,
                                          japi.SAOptions(sample_rate=RATE))
    pats = _patterns(docs, np.random.default_rng([SEED, seed]), k=30)
    enc = [idx._encode_pattern(p) for p in pats]
    lo, hi = idx.ranges_staged(idx.stage_encoded(enc))
    assert (lo == 0).all()
    np.testing.assert_array_equal(hi, idx.count_batch(pats))
    np.testing.assert_array_equal(hi, ref.ranges_staged(
        ref.stage_encoded([ref._encode_pattern(p) for p in pats]))[1])
    assert idx.ranges_staged(idx.stage_encoded([]))[1].shape == (0,)


# ------------------------------------------------- dense longest_match
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_longest_match_len_matches_jax(seed):
    docs = _docs(seed)
    ours = SuffixArrayIndex.from_docs(docs, device="cpu")
    theirs = japi.SuffixArrayIndex.from_docs(docs)
    rng = np.random.default_rng([SEED, seed, 77])
    seqs = [np.concatenate([docs[1][3:40], rng.integers(0, 6, 20)]),
            rng.integers(0, 6, 50), np.full(10, 1000), np.zeros(0),
            np.concatenate([[-1, 7000], docs[2][:25]])]
    from repro.api.index import longest_match_len as jlml
    for seq in seqs:
        want = jlml(theirs, seq)
        assert longest_match_len(ours, seq) == want
        assert ours.longest_match(seq) == want


# --------------------------------------------------------- device rules
def test_sparse_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sparse_suffix_array(np.arange(20) % 3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuffixArrayIndex.build(np.arange(20) % 3, SAOptions(sample_rate=4))


def test_import_repro_torch_sparse_loads_no_jax():
    code = ("import sys, repro_torch.sparse, repro_torch.api; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
