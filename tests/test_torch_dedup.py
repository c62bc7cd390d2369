"""The port's exact-substring dedup (`repro_torch.text.dedup`) and its
deprecated `CorpusSA` shim (`repro_torch.text.corpus_sa`) held against the
JAX package's (`repro.text.dedup`, `repro.text.corpus_sa`): the cases of
tests/core/test_lcp_dedup.py and tests/core/test_corpus_sa.py, and the
gram drop rule over the seeded corpus families of
tests/api/test_fuzz_differential.py (`FAMILIES`) at the pinned
``DEDUP_MIN_LEN = 48`` and at short grams.

Inputs are made with numpy from a seed; deduped bytes, reports, flags,
counts and duplicate triples are compared exactly (tolerance 0). The port
runs with ``device="cpu"``.
"""
import dataclasses
import importlib.util
import inspect
import subprocess
import sys
import warnings
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.text.corpus_sa as jcsa
import repro.text.dedup as jdedup
from repro.core.oracle import suffix_array_naive
from repro_torch.api import SuffixArrayIndex
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.text import corpus_sa, dedup
from repro_torch.text.dedup import (DEDUP_MIN_LEN, dedup_corpus, dedup_docs,
                                    duplicate_gram_flags, find_duplicates,
                                    gram_drop_mask)
from repro_torch.text.lcp import lcp_kasai, ngram_counts

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
SEED = 1616


def _load_families():
    """`FAMILIES` of tests/api/test_fuzz_differential.py, the seeded corpus
    generators of the cross-backend fuzz suite."""
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _load_families()


def _same_report(ours, theirs):
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.dup_fraction == theirs.dup_fraction
    assert ours.dropped_fraction == theirs.dropped_fraction


def _same_dedup(x, **kw):
    """dedup_corpus of both packages on `x`: equal bytes, equal reports;
    returns the port's."""
    out, rep = dedup_corpus(x, device=CPU, **kw)
    jout, jrep = jdedup.dedup_corpus(x, **kw)
    np.testing.assert_array_equal(out, jout)
    assert out.dtype == jout.dtype
    _same_report(rep, jrep)
    return out, rep


# ------------------------------------------------ tests/core/test_lcp_dedup
def test_kasai_matches_naive_and_jax():
    rng = np.random.default_rng(SEED)
    for _ in range(50):
        x = rng.integers(0, 4, int(rng.integers(1, 201)))
        sa = suffix_array_naive(x)
        naive = np.zeros(len(x), np.int64)
        for r in range(1, len(sa)):
            a, b = x[sa[r - 1]:], x[sa[r]:]
            h = 0
            while h < len(a) and h < len(b) and a[h] == b[h]:
                h += 1
            naive[r] = h
        np.testing.assert_array_equal(lcp_kasai(x, sa), naive)
        idx = SuffixArrayIndex.build(x, device=CPU)
        np.testing.assert_array_equal(idx.lcp, naive)


def test_repeated_spans_detects_planted_duplicate():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, 600)
    x[300:360] = x[100:160]
    rep = find_duplicates(x, min_len=40, device=CPU)
    _same_report(rep, jdedup.find_duplicates(x, min_len=40))
    assert rep.dup_chars >= 60
    covered = {p for s, e in rep.spans for p in range(s, e)}
    assert set(range(300, 360)) <= covered or set(range(100, 160)) <= covered


def test_dedup_removes_duplicates_idempotent():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 64, 800)
    x[500:620] = x[100:220]
    out, _ = _same_dedup(x, min_len=64)
    assert len(out) < len(x)
    out2, rep2 = _same_dedup(out, min_len=64)
    assert rep2.dup_chars == 0 or len(out2) == len(out)


def test_ngram_counts():
    x = np.array([0, 1, 0, 1, 0])
    sa = suffix_array_naive(x)
    assert ngram_counts(x, sa, lcp_kasai(x, sa), 2) == 2


def test_dedup_keep_first_keeps_earliest_copy():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, 900)
    x[600:700] = x[100:200]
    out, rep = _same_dedup(x, min_len=64, keep_first=True)
    assert rep.dropped_chars >= 100
    np.testing.assert_array_equal(out[100:200], x[100:200])


def test_dedup_keep_first_false_keeps_latest_copy():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, 900)
    x[600:700] = x[100:200]
    out, rep = _same_dedup(x, min_len=64, keep_first=False)
    assert rep.dropped_chars >= 100
    assert len(out) == 900 - rep.dropped_chars
    tail = out[-(900 - 600 - rep.dropped_chars + 100):]
    window = np.lib.stride_tricks.sliding_window_view(tail, 100)
    assert any(np.array_equal(w, x[600:700]) for w in window)


def test_dedup_both_policies_drop_the_same_char_count():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 32, 1200)
    x[800:900] = x[50:150]
    x[1000:1100] = x[50:150]
    _, first = _same_dedup(x, min_len=48, keep_first=True)
    _, last = _same_dedup(x, min_len=48, keep_first=False)
    assert first.dropped_chars == last.dropped_chars >= 200


def test_dedup_default_min_len_is_pinned():
    assert DEDUP_MIN_LEN == jdedup.DEDUP_MIN_LEN == 48
    for fn in (dedup_corpus, dedup_docs, find_duplicates):
        assert inspect.signature(fn).parameters["min_len"].default \
            == DEDUP_MIN_LEN
    assert PipelineConfig().dedup_min_len == DEDUP_MIN_LEN
    assert PipelineConfig().gate_min_len == DEDUP_MIN_LEN


def test_dedup_empty_corpus_roundtrips():
    out, rep = _same_dedup(np.zeros(0, np.int64))
    assert len(out) == 0
    assert rep.n_chars == rep.dup_chars == rep.dropped_chars == 0
    assert rep.spans == []


def test_dedup_no_spans_returns_corpus_unchanged():
    x = np.arange(200)
    out, rep = _same_dedup(x)
    np.testing.assert_array_equal(out, x)
    assert rep.dup_chars == rep.dropped_chars == 0


# ----------------------------------------------- the drop rule, by family
@pytest.mark.parametrize("min_len", [8, DEDUP_MIN_LEN])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_drop_rule_matches_jax_on_families(family, min_len):
    """dedup_docs, dedup_corpus (both policies) and the gram flags of the
    port equal the JAX package's on each fuzz family, with a planted
    cross-document copy."""
    rng = np.random.default_rng([SEED, sorted(FAMILIES).index(family),
                                 min_len])
    sigma = int(rng.integers(2, 64))
    docs = [np.asarray(FAMILIES[family](rng, int(rng.integers(60, 400)),
                                        sigma), np.int64)
            for _ in range(4)]
    docs.append(np.concatenate([docs[0][:100], docs[2][-60:]]))
    got, rep = dedup_docs(docs, min_len, sigma=sigma, device=CPU)
    want, jrep = jdedup.dedup_docs(docs, min_len, sigma=sigma)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _same_report(rep, jrep)
    idx = SuffixArrayIndex.from_docs(docs, sigma=sigma, device=CPU)
    jidx = japi.SuffixArrayIndex.from_docs(docs, sigma=sigma)
    for keep_first in (True, False):
        flags = duplicate_gram_flags(idx, min_len, keep_first=keep_first)
        np.testing.assert_array_equal(
            flags, jdedup.duplicate_gram_flags(jidx, min_len,
                                               keep_first=keep_first))
        np.testing.assert_array_equal(gram_drop_mask(flags, min_len),
                                      jdedup.gram_drop_mask(flags, min_len))
        _same_dedup(np.concatenate(docs), min_len=min_len,
                    keep_first=keep_first)


def test_sa_builder_is_deprecated_and_still_honoured():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 8, 500)
    x[300:400] = x[0:100]
    with pytest.warns(DeprecationWarning, match="sa_builder"):
        out, rep = dedup_corpus(x, min_len=32, sa_builder=suffix_array_naive,
                                device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout, jrep = jdedup.dedup_corpus(x, min_len=32,
                                         sa_builder=suffix_array_naive)
    np.testing.assert_array_equal(out, jout)
    _same_report(rep, jrep)


def test_dedup_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dedup_docs([np.arange(60) % 5]),
                 lambda: dedup_corpus(np.arange(60) % 5),
                 lambda: find_duplicates(np.arange(60) % 5),
                 lambda: corpus_sa.build_corpus_sa([np.arange(9)])):
        with pytest.raises(RuntimeError, match="device='cpu'"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            call()


# ------------------------------------------------ tests/core/test_corpus_sa
def _legacy(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def test_count_occurrences_matches_naive_and_jax():
    rng = np.random.default_rng(SEED + 1)
    for _ in range(30):
        docs = [rng.integers(0, 4, int(rng.integers(1, 41)))
                for _ in range(int(rng.integers(1, 6)))]
        csa = _legacy(corpus_sa.build_corpus_sa, docs, device=CPU)
        jc = _legacy(jcsa.build_corpus_sa, docs)
        for field in ("text", "sa", "doc_starts"):
            got, want = getattr(csa, field), getattr(jc, field)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        assert (csa.n_docs, csa.sep_count) == (jc.n_docs, jc.sep_count)
        for pattern in [rng.integers(0, 4, int(rng.integers(1, 4)))
                        for _ in range(4)] + [[], [4], [1, 9]]:
            got = _legacy(corpus_sa.count_occurrences, csa, pattern)
            assert got == _legacy(jcsa.count_occurrences, jc, pattern)
            m = len(pattern)
            want = 0 if m == 0 else sum(
                list(d[i:i + m]) == list(pattern)
                for d in docs for i in range(len(d) - m + 1))
            assert got == want


def test_cross_doc_duplicates_detects_contamination():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, 300)
    b = rng.integers(0, 50, 300)
    b[100:180] = a[50:130]
    csa = _legacy(corpus_sa.build_corpus_sa, [a, b], device=CPU)
    hits = _legacy(corpus_sa.cross_doc_duplicates, csa, min_len=60)
    assert hits == _legacy(jcsa.cross_doc_duplicates,
                           _legacy(jcsa.build_corpus_sa, [a, b]), 60)
    assert any(length >= 80 for _, _, length in hits)
    assert all(i == 0 and j == 1 for i, j, _ in hits)
    assert csa.doc_of(150) == 0 and csa.doc_of(400) == 1
    pos = np.array([0, 300, 301, 600])
    np.testing.assert_array_equal(
        csa.doc_of(pos), _legacy(jcsa.build_corpus_sa, [a, b]).doc_of(pos))


def test_no_cross_document_suffix_confusion():
    csa = _legacy(corpus_sa.build_corpus_sa, [[0, 1], [0, 1]], device=CPU)
    assert _legacy(corpus_sa.count_occurrences, csa, [0, 1]) == 2
    assert _legacy(corpus_sa.count_occurrences, csa, [1, 0]) == 0


def test_corpus_sa_shims_warn_with_the_port_names():
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.text.corpus_sa.build_corpus_sa"):
        csa = corpus_sa.build_corpus_sa([[0, 1, 2]], device=CPU)
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.api.SuffixArrayIndex.count"):
        assert corpus_sa.count_occurrences(csa, [1, 2]) == 1
    with pytest.warns(DeprecationWarning, match="cross_doc_duplicates"):
        assert corpus_sa.cross_doc_duplicates(csa, 2) == []
    empty = _legacy(corpus_sa.build_corpus_sa, [], device=CPU)
    assert (empty.n_docs, len(empty.text), len(empty.sa)) == (0, 0, 0)
    idx = csa.as_index()
    assert idx.device == torch.device(CPU) and idx.count([0, 1]) == 1
    assert _legacy(corpus_sa.build_corpus_sa, [[3, 1, 3, 1]],
                   sa_builder=suffix_array_naive,
                   device=CPU).sa.tolist() == \
        _legacy(jcsa.build_corpus_sa, [[3, 1, 3, 1]]).sa.tolist()


# ------------------------------------------------------------- the guard
def test_import_dedup_modules_loads_no_jax():
    code = ("import sys, repro_torch.data.pipeline, repro_torch.text.dedup, "
            "repro_torch.text.corpus_sa; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert dedup.__name__ == "repro_torch.text.dedup"
