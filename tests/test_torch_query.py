"""The port's index and batched queries (`repro_torch.api`) held against the
JAX package's (`repro.api`): `sa_ranges_batch`, `count_batch`,
`locate_batch`, `locate_docs_batch` and `contains_batch` on the cases of
tests/api/test_query.py (empty, absent, full-text and separator-spanning
patterns, out-of-alphabet values that raise), on the fuzz families, and on
an index built by `repro` and carried into the port with
`index_from_numpy_state`.

Inputs are made with numpy from a seed; every comparison is on integers and
exact (tolerance 0). The port runs with ``device="cpu"``.
"""
import importlib.util
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
from repro_torch.api import (QueryBatch, SAOptions, SuffixArrayIndex,
                             batch_ranges, index_from_numpy_state,
                             stage_batch)

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
SEED = 20261018


def _load_families():
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families_q", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _load_families()


def _carry(ref) -> SuffixArrayIndex:
    state = {"text": ref.text, "sa": ref.sa, "doc_starts": ref.doc_starts,
             "shift": ref.shift, "sigma": ref.sigma}
    return index_from_numpy_state(state, device=CPU)


# --------------------------------------------- the cases of test_query.py
def _single():
    text = np.random.default_rng(5).integers(0, 4, 300)
    return (japi.SuffixArrayIndex.build(text),
            SuffixArrayIndex.build(text, device=CPU), None)


def _multi():
    rng = np.random.default_rng(6)
    docs = [rng.integers(0, 4, int(rng.integers(10, 80))) for _ in range(4)]
    return (japi.SuffixArrayIndex.from_docs(docs),
            SuffixArrayIndex.from_docs(docs, device=CPU), docs)


def _periodic():
    text = np.tile([0, 1, 2], 60)
    return (japi.SuffixArrayIndex.build(text),
            SuffixArrayIndex.build(text, device=CPU), None)


CORPORA = {"single": _single, "multi": _multi, "periodic": _periodic}


def _pattern_matrix(idx, docs):
    """Mixed-length patterns: planted, random, absent, full text, longer
    than the text, each full document, separator-spanning."""
    rng = np.random.default_rng(7)
    raw = (idx.text - idx.shift) if idx.shift else idx.text
    pats = [[]]
    for m in (1, 2, 3, 7, 16, 33):
        at = int(rng.integers(0, max(idx.n - m, 1)))
        if idx.shift == 0 or (idx.text[at:at + m] >= idx.shift).all():
            pats.append(raw[at:at + m].tolist())
        pats.append(rng.integers(0, idx.sigma, size=m).tolist())
    pats.append([idx.sigma - 1] * 40)
    if docs is None:
        pats.append(raw.tolist())
        pats.append(raw.tolist() + [0])
    else:
        pats.extend(np.asarray(d).tolist() for d in docs)
        pats.append(np.concatenate([docs[0][-2:], docs[1][:2]]).tolist())
    return pats


def _assert_same_answers(got, want, pats):
    for a, b in zip(got.sa_ranges_batch(pats), want.sa_ranges_batch(pats)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.count_batch(pats),
                                  want.count_batch(pats))
    np.testing.assert_array_equal(got.contains_batch(pats),
                                  want.contains_batch(pats))
    located = [p for p in pats if len(p)]
    for a, b in zip(got.locate_batch(located), want.locate_batch(located)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.locate_docs_batch(located),
                    want.locate_docs_batch(located)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_queries_match_jax(corpus):
    ref, idx, docs = CORPORA[corpus]()
    np.testing.assert_array_equal(idx.sa.numpy(), ref.sa)
    assert (idx.n, idx.sigma, idx.shift) == (ref.n, ref.sigma, ref.shift)
    pats = _pattern_matrix(ref, docs)
    _assert_same_answers(idx, ref, pats)
    for p in [p for p in pats if len(p)][:5]:     # scalar shims
        assert idx.count(p) == ref.count(p)
        np.testing.assert_array_equal(idx.locate(p), ref.locate(p))
        np.testing.assert_array_equal(idx.locate_docs(p), ref.locate_docs(p))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_carried_index_matches_jax(corpus):
    ref, _, docs = CORPORA[corpus]()
    idx = _carry(ref)
    assert idx.sa.dtype == torch.int32 and idx.text.dtype == torch.int64
    _assert_same_answers(idx, ref, _pattern_matrix(ref, docs))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_family_queries_match_jax(family, impl):
    rng = np.random.default_rng([SEED, sorted(FAMILIES).index(family)])
    sigma = int(rng.integers(2, 32))
    docs = [FAMILIES[family](rng, int(rng.integers(30, 400)), sigma)
            for _ in range(4)]
    ref = japi.SuffixArrayIndex.from_docs(docs, sigma=sigma)
    idx = SuffixArrayIndex.from_docs(docs, SAOptions(sort_impl=impl),
                                     sigma=sigma, device=CPU)
    np.testing.assert_array_equal(idx.sa.numpy(), ref.sa)
    pats = []
    for d in docs:                      # planted — must hit
        at = int(rng.integers(0, max(len(d) - 5, 1)))
        pats.append(np.asarray(d[at:at + 5], np.int64))
    pats += [rng.integers(0, sigma, int(m)) for m in (1, 2, 5, 9)]
    pats.append(np.asarray(docs[0], np.int64))
    pats.append(np.zeros(0, np.int64))
    _assert_same_answers(idx, ref, pats)
    assert (idx.count_batch(pats[:4]) > 0).all()


def _stats(s):
    return (s.k, s.total, s.distinct)


def test_lcp_methods_match_jax():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 5, 60)
    docs = [np.concatenate([rng.integers(0, 5, 40), base]),
            np.concatenate([base, rng.integers(0, 5, 30)]),
            rng.integers(0, 5, 50)]
    ref = japi.SuffixArrayIndex.from_docs(docs)
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    np.testing.assert_array_equal(idx.lcp, ref.lcp)
    for k in (1, 3, 8):
        assert _stats(idx.ngram_stats(k)) == _stats(ref.ngram_stats(k))
    assert idx.duplicate_spans(10) == ref.duplicate_spans(10)
    assert idx.cross_doc_duplicates(10) == ref.cross_doc_duplicates(10)
    single = SuffixArrayIndex.build(docs[0], device=CPU)
    assert _stats(single.ngram_stats(4)) == _stats(
        japi.SuffixArrayIndex.build(docs[0]).ngram_stats(4))


# ------------------------------------------------------- pattern semantics
def test_empty_pattern_counts_n_and_locate_raises():
    _, idx, _ = _single()
    assert idx.count([]) == idx.n
    assert int(idx.count_batch([[]])[0]) == idx.n
    with pytest.raises(ValueError, match="empty pattern"):
        idx.locate([])
    with pytest.raises(ValueError, match="empty pattern"):
        idx.locate_batch([[1], []])
    empty = SuffixArrayIndex.build(np.zeros(0, np.int64), device=CPU)
    assert empty.count([]) == 0
    assert empty.count([7]) == 0


def test_out_of_alphabet_pattern_rejected():
    idx = SuffixArrayIndex.build(np.asarray([0, 2, 1, 2]), device=CPU)
    assert idx.sigma == 3
    with pytest.raises(ValueError, match="alphabet"):
        idx.count([3])
    with pytest.raises(ValueError, match="alphabet"):
        idx.count_batch([[0], [5]])
    with pytest.raises(ValueError):
        idx.count([-1])


def test_declared_sigma_past_int32_never_false_matches():
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 2, 0]), sigma=2 ** 40,
                                 device=CPU)
    assert idx.count([2 ** 32]) == 0
    assert idx.count_batch([[2 ** 32], [0], [2 ** 33, 1]]).tolist() \
        == [0, 2, 0]


def test_pattern_longer_than_text_and_cross_separator():
    idx = SuffixArrayIndex.build(np.asarray([1, 2]), device=CPU)
    assert idx.count_batch([[1, 2, 1], [1, 2]]).tolist() == [0, 1]
    docs = SuffixArrayIndex.from_docs([[0, 1], [0, 1]], device=CPU)
    assert docs.count_batch([[0, 1], [1, 0]]).tolist() == [2, 0]


def test_batch_is_bound_to_its_index_and_staging_matches():
    _, idx, _ = _single()
    _, other, _ = _periodic()
    pats = [[0, 1], [2], [3, 3, 3]]
    qb = QueryBatch.encode(idx, pats)
    assert qb.bucket == (4, 8) and len(qb) == 3
    with pytest.raises(ValueError, match="different index"):
        other.count_batch(qb)
    lo, hi = batch_ranges(idx, qb, staged=stage_batch(idx, qb))
    lo2, hi2 = idx.sa_ranges_batch(qb)
    np.testing.assert_array_equal(lo, lo2)
    np.testing.assert_array_equal(hi, hi2)


def test_persistence_is_not_ported_yet(tmp_path):
    """Persistence is ported: `save` / `load` round-trip an index, and the
    restored one answers as the JAX package's does. What is not ported is
    the reference checkpoint's elastic ``shardings=`` restore onto a
    device mesh, which has no counterpart on one card."""
    from repro_torch.ckpt import restore_checkpoint
    ref, idx, _ = _single()
    _ = idx.lcp
    path = str(tmp_path / "idx")
    assert idx.save(path) == path
    got = SuffixArrayIndex.load(path, device=CPU)
    np.testing.assert_array_equal(got.sa.numpy(), ref.sa)
    np.testing.assert_array_equal(got.lcp, ref.lcp)
    _assert_same_answers(got, ref, _pattern_matrix(ref, None))
    with pytest.raises(TypeError, match="shardings"):
        restore_checkpoint(path, 0, {}, shardings=None)
