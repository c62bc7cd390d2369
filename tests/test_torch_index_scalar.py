"""The port's scalar search oracle (`repro_torch.api.SuffixArrayIndex.
_suffix_cmp` / `_sa_range`) held against the JAX package's
(`repro.api.index`), and the port's batched search held against it.

* `_sa_range` equals `repro`'s pattern by pattern over the seeded corpus
  families of tests/api/test_fuzz_differential.py (`FAMILIES`), with
  planted, random, absent, empty and too-long patterns.
* The port's `sa_ranges_batch` equals its own `_sa_range` on the same
  patterns (as tests/api/test_query.py holds `repro`'s).
* The empty-index and empty-pattern cases of tests/api/test_index_edges.py,
  run against the port.

Every comparison is on integers and exact. The port runs with
``device="cpu"``.
"""
import numpy as np
import pytest

import repro.api as japi
from repro_torch.api import SuffixArrayIndex
from test_torch_query import FAMILIES

CPU = "cpu"
SEED = 20261021


def _family_case(family):
    rng = np.random.default_rng([SEED, sorted(FAMILIES).index(family)])
    sigma = int(rng.integers(2, 32))
    docs = [FAMILIES[family](rng, int(rng.integers(30, 300)), sigma)
            for _ in range(3)]
    ref = japi.SuffixArrayIndex.from_docs(docs, sigma=sigma)
    idx = SuffixArrayIndex.from_docs(docs, sigma=sigma, device=CPU)
    raw = ref.text - ref.shift
    pats = [[]]
    for m in (1, 2, 3, 5, 9, 17, 40):
        at = int(rng.integers(0, max(ref.n - m, 1)))
        if (ref.text[at:at + m] >= ref.shift).all():
            pats.append(raw[at:at + m].tolist())           # planted
        pats.append(rng.integers(0, sigma, size=m).tolist())
    pats.append([sigma - 1] * (ref.n + 1))                 # longer than n
    pats.extend(np.asarray(d).tolist() for d in docs)
    return ref, idx, pats


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sa_range_matches_jax(family):
    ref, idx, pats = _family_case(family)
    np.testing.assert_array_equal(idx.sa.numpy(), ref.sa)
    for p in pats:
        enc = idx._encode_pattern(p)
        np.testing.assert_array_equal(enc, ref._encode_pattern(p))
        assert idx._sa_range(enc) == ref._sa_range(enc), p
    # the comparator itself, at every rank, for the planted patterns
    ranks = np.arange(ref.n)
    for p in pats[1:6]:
        enc = idx._encode_pattern(p)
        np.testing.assert_array_equal(
            idx._suffix_cmp(ref.sa[ranks], enc),
            ref._suffix_cmp(ref.sa[ranks], enc))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batch_ranges_match_the_scalar_oracle(family):
    _, idx, pats = _family_case(family)
    lo, hi = idx.sa_ranges_batch(pats)
    want = [idx._sa_range(idx._encode_pattern(p)) for p in pats]
    assert lo.tolist() == [w[0] for w in want]
    assert hi.tolist() == [w[1] for w in want]
    assert idx.count_batch(pats).tolist() == [h - l for l, h in want]


def test_suffix_cmp_no_wraparound_on_empty_index():
    idx = SuffixArrayIndex.from_docs([], device=CPU)
    # on n == 0 every suffix is past-the-end, strictly below any pattern,
    # and the gather never wraps to text[-1]
    assert idx._suffix_cmp(np.array([0]), np.array([3])).tolist() == [-1]
    out = idx._suffix_cmp(np.array([0, 1]), np.zeros(0, np.int64))
    assert out.tolist() == [0, 0]       # empty pattern prefixes everything
    assert idx._sa_range(np.array([3])) == (0, 0)
    assert idx._sa_range(np.zeros(0, np.int64)) == (0, 0)


def test_empty_pattern_spans_every_rank():
    text = np.random.default_rng(SEED).integers(0, 4, 50)
    idx = SuffixArrayIndex.build(text, device=CPU)
    ref = japi.SuffixArrayIndex.build(text)
    empty = idx._encode_pattern([])
    assert idx._sa_range(empty) == ref._sa_range(empty) == (0, 50)
    assert idx._suffix_cmp(np.arange(50), empty).tolist() == [0] * 50
    lo, hi = idx.sa_ranges_batch([[]])
    assert (int(lo[0]), int(hi[0])) == (0, 50)
