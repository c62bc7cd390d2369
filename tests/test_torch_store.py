"""The port's persistence (`repro_torch.api.store`, `repro_torch.ckpt`) held
against the JAX package's (`repro.api.store`, `repro.ckpt`): the cases of
tests/api/test_store.py (round trips, every `StaleIndexError` and
`ValueError`, atomic `get_or_build` stats), the corpus fingerprint, and
indexes saved by one package and loaded by the other, both ways.

Inputs are made with numpy from a seed; every comparison is on integers
and exact (tolerance 0). The port runs with ``device="cpu"``; the JAX
side builds with the "seq" backend where its jitted build would be slow.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import zipfile
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.ckpt import checkpoint as jckpt
from repro_torch.api import (IndexStore, SAOptions, SegmentedIndex,
                             SegmentedIndexStore, StaleIndexError,
                             SuffixArrayIndex, corpus_fingerprint,
                             encode_docs, load_index, save_index)
from repro_torch.ckpt import (restore_checkpoint, save_checkpoint,
                              wait_for_async)
from repro_torch.sparse import SparseSuffixArrayIndex
from repro_torch.trace import counters

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
JSEQ = japi.SAOptions(backend="seq")


def _docs(seed=3, n_docs=3, max_len=60, sigma=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, sigma, int(rng.integers(5, max_len)))
            for _ in range(n_docs)]


def _same_index(got, want):
    """Equal text, SA, doc_starts, structure and (when cached) LCP; either
    side may be a port index (tensors) or a JAX-package index (numpy)."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(host(got.text), host(want.text))
    np.testing.assert_array_equal(host(got.sa), host(want.sa))
    np.testing.assert_array_equal(got.doc_starts, want.doc_starts)
    assert (got.shift, got.sigma, got.n_docs) == \
        (want.shift, want.sigma, want.n_docs)
    assert (got._lcp is None) == (want._lcp is None)
    if want._lcp is not None:
        np.testing.assert_array_equal(got._lcp, want._lcp)


# ----------------------------------------------------------- fingerprint
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_fingerprint_matches_jax(seed):
    docs = _docs(seed)
    text, _, _ = encode_docs(docs)
    want = japi.corpus_fingerprint(japi.encode_docs(docs)[0])
    assert corpus_fingerprint(text) == want
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    assert corpus_fingerprint(idx.text) == want         # a tensor hashes too
    assert corpus_fingerprint(np.zeros(0)) == \
        japi.corpus_fingerprint(np.zeros(0))


def test_fingerprint_covers_plan_not_runtime():
    base = SAOptions(backend="torch", v0=3)
    assert base.fingerprint() == SAOptions(backend="torch").fingerprint()
    assert base.fingerprint() == \
        SAOptions(backend="torch", counters=object(), stats=object(),
                  validate=False).fingerprint()
    for change in ({"v0": 7}, {"schedule": "fixed"}, {"base_threshold": 99},
                   {"sort_impl": "torch"}, {"backend": "seq"},
                   {"sample_rate": 4}):
        assert base.replace(**change).fingerprint() != base.fingerprint()


@pytest.mark.parametrize("ours,theirs", [
    ({}, {}),
    ({"backend": "torch"}, {"backend": "jax"}),
    ({"sort_impl": "kernel"}, {"sort_impl": "pallas"}),
    ({"sort_impl": "torch", "v0": 7}, {"sort_impl": "lax", "v0": 7}),
    ({"sort_impl": "radix", "sample_rate": 4},
     {"sort_impl": "radix", "sample_rate": 4}),
    ({"backend": "seq", "schedule": "fixed", "base_threshold": 64},
     {"backend": "seq", "schedule": "fixed", "base_threshold": 64}),
])
def test_plan_fingerprint_is_the_jax_packages(ours, theirs):
    assert SAOptions(**ours).fingerprint() == \
        japi.SAOptions(**theirs).fingerprint()


# ------------------------------------------------------------ round trips
@pytest.mark.parametrize("backend", ["torch", "seq", "oracle"])
def test_save_load_query_roundtrip(backend, tmp_path):
    docs = _docs()
    opts = SAOptions(backend=backend, base_threshold=64)
    idx = SuffixArrayIndex.from_docs(docs, opts, device=CPU)
    path = str(tmp_path / "idx")
    assert idx.save(path) == path
    got = SuffixArrayIndex.load(path, options=opts, device=CPU)
    _same_index(got, idx)
    assert got.device == torch.device(CPU)
    pats = [docs[0][:4].tolist(), docs[1].tolist(), [4, 4, 4, 4]]
    assert got.count_batch(pats).tolist() == idx.count_batch(pats).tolist()
    assert got.locate(pats[0]).tolist() == idx.locate(pats[0]).tolist()
    assert got.cross_doc_duplicates(2) == idx.cross_doc_duplicates(2)
    ref = japi.SuffixArrayIndex.from_docs(docs, JSEQ)
    assert got.count_batch(pats).tolist() == ref.count_batch(pats).tolist()


def test_restored_index_resaves_with_same_plan_fingerprint(tmp_path):
    opts = SAOptions(backend="torch", v0=7, schedule="fixed")
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 2, 0, 1]), opts,
                                 device=CPU)
    p1, p2, p3 = (str(tmp_path / n) for n in ("a", "b", "c"))
    idx.save(p1)
    restored = SuffixArrayIndex.load(p1, device=CPU)
    assert restored.options.fingerprint() == opts.fingerprint()
    assert (restored.options.backend, restored.options.v0) == ("torch", 7)
    restored.save(p2)
    assert SuffixArrayIndex.load(p2, options=opts, device=CPU).n == idx.n
    SuffixArrayIndex.load(p1, options=opts, device=CPU).save(p3)
    assert SuffixArrayIndex.load(p3, options=opts, device=CPU).n == idx.n


def test_callable_schedule_keeps_other_plan_fields(tmp_path):
    opts = SAOptions(backend="torch", v0=7, schedule=lambda v, d, m: m,
                     sort_impl="torch")
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 2, 0, 1]), opts,
                                 device=CPU)
    path = str(tmp_path / "idx")
    idx.save(path)
    ro = SuffixArrayIndex.load(path, device=CPU).options
    assert (ro.backend, ro.v0, ro.sort_impl) == ("torch", 7, "torch")
    assert ro.schedule == "accelerated"       # the one lossy field


def test_lcp_persisted_only_when_computed(tmp_path):
    idx = SuffixArrayIndex.build(np.tile([0, 1, 2], 40), device=CPU)
    p1 = str(tmp_path / "nolcp")
    idx.save(p1)
    assert SuffixArrayIndex.load(p1, device=CPU)._lcp is None
    _ = idx.lcp
    p2 = str(tmp_path / "lcp")
    idx.save(p2)
    restored = SuffixArrayIndex.load(p2, device=CPU)
    assert restored._lcp is not None
    np.testing.assert_array_equal(restored.lcp, idx.lcp)


def test_empty_index_roundtrip(tmp_path):
    idx = SuffixArrayIndex.from_docs([], device=CPU)
    path = str(tmp_path / "empty")
    idx.save(path)
    got = SuffixArrayIndex.load(path, device=CPU)
    assert got.n == 0 and got.n_docs == 0 and got.count([]) == 0


#: the port's backend × sort_impl cells (oracle/seq ignore sort_impl).
_RT_CELLS = ([("oracle", "auto"), ("seq", "auto")]
             + [("torch", s) for s in ("auto", "kernel", "torch", "radix")])


@pytest.mark.parametrize("backend,sort_impl", _RT_CELLS,
                         ids=[f"{b}-{s}" for b, s in _RT_CELLS])
def test_roundtrip_matrix(backend, sort_impl, tmp_path):
    docs = _docs(seed=7)
    opts = SAOptions(backend=backend, sort_impl=sort_impl, base_threshold=64)
    idx = SuffixArrayIndex.from_docs(docs, opts, device=CPU)
    path = str(tmp_path / "idx")
    save_index(path, idx)
    got = load_index(path, options=opts, device=CPU)
    _same_index(got, idx)
    pats = [docs[0][:3].tolist(), [4, 4, 4], [0]]
    assert got.count_batch(pats).tolist() == idx.count_batch(pats).tolist()
    other = "torch" if sort_impl != "torch" else "radix"
    with pytest.raises(StaleIndexError, match="plan"):
        load_index(path, options=opts.replace(sort_impl=other), device=CPU)


# -------------------------------------------------------------- staleness
def test_load_rejects_wrong_plan_and_corpus(tmp_path):
    idx = SuffixArrayIndex.from_docs(_docs(), device=CPU)
    path = str(tmp_path / "idx")
    save_index(path, idx)
    with pytest.raises(StaleIndexError, match="plan"):
        load_index(path, options=SAOptions(v0=7), device=CPU)
    with pytest.raises(StaleIndexError, match="corpus"):
        load_index(path, expect_corpus_sha="0" * 64, device=CPU)
    with pytest.raises(StaleIndexError, match="rolled back"):
        load_index(path, expect_step=1, device=CPU)
    assert load_index(path, device=CPU).n == idx.n


def _edit_manifest(path, **extras):
    mpath = os.path.join(path, "step_00000000", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["extras"].update(extras)
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def test_load_rejects_format_version_and_kind(tmp_path):
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 0, 1]), device=CPU)
    path = str(tmp_path / "idx")
    save_index(path, idx)
    _edit_manifest(path, format=999)
    with pytest.raises(StaleIndexError, match="format"):
        load_index(path, device=CPU)
    _edit_manifest(path, kind="lm-checkpoint")
    with pytest.raises(StaleIndexError, match="not a suffix-array"):
        load_index(path, device=CPU)
    with open(os.path.join(path, "step_00000000", "manifest.json"),
              "w") as f:
        f.write("{not json")
    with pytest.raises(StaleIndexError, match="unreadable"):
        load_index(path, device=CPU)
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "absent"), device=CPU)


def test_manifest_leaf_count_mismatch_is_stale(tmp_path):
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 2, 1]), device=CPU)
    path = str(tmp_path / "idx")
    save_index(path, idx)
    _edit_manifest(path, has_lcp=True)      # claims a 4th leaf
    with pytest.raises(StaleIndexError, match="leaves"):
        load_index(path, device=CPU)


def test_get_or_build_traffic(tmp_path):
    docs = _docs(seed=11)
    opts = SAOptions()
    sha = corpus_fingerprint(encode_docs(docs)[0])
    store = IndexStore(str(tmp_path / "store"), device=CPU)
    builds = []

    def build():
        builds.append(1)
        return SuffixArrayIndex.from_docs(docs, opts, device=CPU)

    _, s1 = store.get_or_build("c", build, options=opts, corpus_sha=sha)
    idx, s2 = store.get_or_build("c", build, options=opts, corpus_sha=sha)
    assert (s1, s2) == ("miss", "hit") and len(builds) == 1
    assert idx.device == torch.device(CPU)
    _, s3 = store.get_or_build("c", build, options=opts,
                               corpus_sha="f" * 64)
    assert s3 == "stale" and len(builds) == 2
    assert store.stats() == {"entries": 1, "hits": 1, "misses": 1,
                             "stale": 1}
    assert store.entries() == ["c"]
    assert store.manifest_age("c") is not None
    assert store.manifest_age("nope") is None
    for bad in ("../escape", "", ".hidden"):
        with pytest.raises(ValueError):
            store.path(bad)
    with pytest.raises(FileNotFoundError):
        store.load("nope")


def test_get_or_build_stats_are_atomic(tmp_path):
    docs = _docs(seed=21)
    opts = SAOptions()
    store = IndexStore(str(tmp_path / "store"), device=CPU)

    def boom():
        raise RuntimeError("builder exploded")

    with pytest.raises(RuntimeError, match="exploded"):
        store.get_or_build("c", boom, options=opts)
    assert store.stats() == {"entries": 0, "hits": 0, "misses": 0,
                             "stale": 0}
    build = lambda: SuffixArrayIndex.from_docs(docs, opts, device=CPU)
    assert store.get_or_build("c", build, options=opts)[1] == "miss"
    with pytest.raises(RuntimeError, match="exploded"):
        store.get_or_build("c", boom, options=SAOptions(v0=7))
    assert store.stats() == {"entries": 1, "hits": 0, "misses": 1,
                             "stale": 0}
    assert store.get_or_build("c", build, options=opts)[1] == "hit"


def test_get_or_build_stats_under_threads(tmp_path):
    """More threads than cores and a short switch interval: no stat
    increment may be lost."""
    docs = _docs(seed=22)
    store = IndexStore(str(tmp_path / "store"), device=CPU)
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    store.save("c", idx)
    statuses, errs = [], []

    def worker():
        try:
            statuses.append(store.get_or_build("c", lambda: idx,
                                               options=SAOptions())[1])
        except Exception as e:                      # pragma: no cover
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs and statuses == ["hit"] * len(threads)
    assert store.stats()["hits"] == len(threads)


# ------------------------------------------------- sparse index persistence
def test_sparse_roundtrip_and_rate_mismatch(tmp_path):
    docs = _docs(seed=31, max_len=80)
    opts = SAOptions(sample_rate=4)
    idx = SuffixArrayIndex.from_docs(docs, opts, device=CPU)
    path = str(tmp_path / "sparse")
    save_index(path, idx)
    got = load_index(path, options=opts, device=CPU)
    assert isinstance(got, SparseSuffixArrayIndex) and got.sample_rate == 4
    _same_index(got, idx)
    pats = [docs[0][:4].tolist(), docs[0][:5].tolist(), [4, 4, 4, 4]]
    assert got.count_batch(pats).tolist() == idx.count_batch(pats).tolist()
    assert got.locate(pats[0]).tolist() == idx.locate(pats[0]).tolist()
    restored = load_index(path, device=CPU)
    assert isinstance(restored, SparseSuffixArrayIndex)
    assert restored.options.fingerprint() == opts.fingerprint()
    with pytest.raises(StaleIndexError, match="plan"):
        load_index(path, options=opts.replace(sample_rate=8), device=CPU)
    with pytest.raises(StaleIndexError, match="plan"):
        load_index(path, options=SAOptions(), device=CPU)


def test_sparse_kind_rate_tamper_is_stale(tmp_path):
    text = np.arange(64) % 5
    for build_rate, forged in ((4, 1), (1, 4)):
        idx = SuffixArrayIndex.build(text, SAOptions(sample_rate=build_rate),
                                     device=CPU)
        path = str(tmp_path / f"r{build_rate}")
        save_index(path, idx)
        _edit_manifest(path, sample_rate=forged)
        with pytest.raises(StaleIndexError, match="tampered|half-written"):
            load_index(path, device=CPU)


# ------------------------------------------------ across the two packages
def _ref_index(docs, rate):
    ref = japi.SuffixArrayIndex.from_docs(
        docs, japi.SAOptions(backend="seq") if rate == 1
        else japi.SAOptions(sample_rate=rate))
    _ = ref.lcp
    return ref


@pytest.mark.parametrize("rate", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_saved_by_jax_loads_in_port(rate, seed, tmp_path):
    docs = _docs(seed, n_docs=4, max_len=90)
    ref = _ref_index(docs, rate)
    path = str(tmp_path / "idx")
    japi.save_index(path, ref)
    got = load_index(path, device=CPU)
    assert isinstance(got, SparseSuffixArrayIndex) == (rate > 1)
    _same_index(got, ref)
    assert got.options.fingerprint() == ref.options.fingerprint()
    pats = [d[2:6].tolist() for d in docs]
    np.testing.assert_array_equal(got.count_batch(pats),
                                  ref.count_batch(pats))


@pytest.mark.parametrize("rate", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_saved_by_port_loads_in_jax(rate, seed, tmp_path):
    docs = _docs(seed, n_docs=4, max_len=90)
    ours = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=rate),
                                      device=CPU)
    _ = ours.lcp
    path = str(tmp_path / "idx")
    ours.save(path)
    got = japi.load_index(path)
    _same_index(got, ours)
    _same_index(got, _ref_index(docs, rate))
    assert got.options.fingerprint() == ours.options.fingerprint()


@pytest.mark.parametrize("ours,theirs", [
    ({}, {}),
    ({"backend": "torch", "sort_impl": "torch"},
     {"backend": "jax", "sort_impl": "lax"}),
    ({"sort_impl": "kernel", "base_threshold": 64},
     {"sort_impl": "pallas", "base_threshold": 64}),
])
def test_one_plan_is_one_entry_for_both_packages(ours, theirs, tmp_path):
    docs = _docs(seed=5)
    popts, jopts = SAOptions(**ours), japi.SAOptions(**theirs)
    sha = corpus_fingerprint(encode_docs(docs)[0])
    pstore = IndexStore(str(tmp_path), device=CPU)
    jstore = japi.IndexStore(str(tmp_path))
    pstore.save("p", SuffixArrayIndex.from_docs(docs, popts, device=CPU))
    ref = japi.SuffixArrayIndex.from_docs(docs, JSEQ)   # the SA, quickly,
    jstore.save("j", japi.SuffixArrayIndex(             # filed under jopts
        ref.text, ref.sa, doc_starts=ref.doc_starts, shift=ref.shift,
        options=jopts))
    never = lambda: pytest.fail("a hit must not build")   # noqa: E731
    assert jstore.get_or_build("p", never, options=jopts,
                               corpus_sha=sha)[1] == "hit"
    got, status = pstore.get_or_build("j", never, options=popts,
                                      corpus_sha=sha)
    assert status == "hit"
    assert got.options.fingerprint() == popts.fingerprint()
    assert got.options.sort_impl == popts.sort_impl
    # a genuinely different plan is stale, both ways
    with pytest.raises(japi.StaleIndexError, match="plan"):
        jstore.load("p", options=jopts.replace(v0=7))
    with pytest.raises(StaleIndexError, match="plan"):
        pstore.load("j", options=popts.replace(v0=7))


def test_bitonic_plan_has_no_port_counterpart(tmp_path):
    docs = _docs(seed=6)
    ref = japi.SuffixArrayIndex.from_docs(docs, JSEQ)
    ref = japi.SuffixArrayIndex(ref.text, ref.sa, doc_starts=ref.doc_starts,
                                shift=ref.shift,
                                options=japi.SAOptions(sort_impl="bitonic"))
    path = str(tmp_path / "idx")
    japi.save_index(path, ref)
    with pytest.raises(StaleIndexError, match="plan"):
        load_index(path, options=SAOptions(), device=CPU)
    # the port now has the counterpart: the plan restores as the port's
    got = load_index(path, device=CPU)
    assert got.options.sort_impl == "bitonic"
    assert got.options.fingerprint() == ref.options.fingerprint()
    np.testing.assert_array_equal(got.sa.numpy(), np.asarray(ref.sa))
    assert load_index(path, options=SAOptions(sort_impl="bitonic"),
                      device=CPU).options.sort_impl == "bitonic"


def test_segmented_entries_load_across_packages(tmp_path):
    docs = _docs(seed=9, n_docs=6)
    pats = [d[:3].tolist() for d in docs]
    jseg = japi.SegmentedIndex.from_docs(docs, JSEQ, segment_docs=2)
    japi.SegmentedIndexStore(str(tmp_path)).save("j", jseg)
    got = SegmentedIndexStore(str(tmp_path), device=CPU).load(
        "j", options=SAOptions(backend="seq"))
    assert got.n_segments == 3
    np.testing.assert_array_equal(got.count_batch(pats),
                                  jseg.count_batch(pats))
    pseg = SegmentedIndex.from_docs(docs, SAOptions(), segment_docs=3,
                                    device=CPU)
    SegmentedIndexStore(str(tmp_path), device=CPU).save("p", pseg)
    back = japi.SegmentedIndexStore(str(tmp_path)).load(
        "p", options=japi.SAOptions())
    for a, b in zip(back.locate_batch(pats), pseg.locate_batch(pats)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------- segmented store: dirty sync
def test_segmented_store_writes_only_dirty_segments(tmp_path):
    opts = SAOptions(compact_fanin=64)
    seg = SegmentedIndex.from_docs(_docs(n_docs=6), opts, segment_docs=2,
                                   device=CPU)
    store = SegmentedIndexStore(str(tmp_path), device=CPU)
    assert store.save("c", seg) == {"segments_written": 3,
                                    "segments_deleted": 0}
    assert store.save("c", seg) == {"segments_written": 0,
                                    "segments_deleted": 0}
    seg.add_docs([[1, 2, 3, 4]])
    assert store.save("c", seg) == {"segments_written": 1,
                                    "segments_deleted": 0}
    seg.delete_doc(0)                    # rebuilds its segment: one new,
    assert store.save("c", seg) == {"segments_written": 1,    # one dropped
                                    "segments_deleted": 1}
    before = counters().get("repro_torch.builds", 0)
    loaded = store.load("c", options=opts)
    assert counters().get("repro_torch.builds", 0) == before
    assert loaded.n_docs == 6 and loaded.count([1, 2, 3, 4]) >= 1
    assert store.stats()["segments_written"] == 5


# ------------------------------------------- restore_checkpoint hardening
def _tree():
    return {"a": np.arange(6, dtype=np.int32),
            "b": np.ones((2, 3), np.float32)}


def test_restore_validates_shape_dtype_and_count(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree())
    ok, extras = restore_checkpoint(d, 0, _tree())
    np.testing.assert_array_equal(ok["a"], _tree()["a"])
    assert extras == {}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 0, {"a": np.zeros(5, np.int32),
                                  "b": np.ones((2, 3), np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(d, 0, {"a": np.zeros(6, np.int64),
                                  "b": np.ones((2, 3), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(d, 0, {"a": np.zeros(6, np.int32)})
    with pytest.raises(FileNotFoundError, match="COMMITTED"):
        restore_checkpoint(d, 99, _tree())


def test_restore_detects_manifest_npz_disagreement(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree())
    np.savez(os.path.join(d, "step_00000000", "arrays.npz"),
             **{"0": np.arange(4, dtype=np.int32),
                "1": np.ones((2, 3), np.float32)})
    with pytest.raises(ValueError, match="manifest"):
        restore_checkpoint(d, 0, {"a": np.zeros(4, np.int32),
                                  "b": np.ones((2, 3), np.float32)})


def test_restore_detects_truncated_npz(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree())
    npz = os.path.join(d, "step_00000000", "arrays.npz")
    with zipfile.ZipFile(npz) as z:
        keep = z.read("0.npy")
    with zipfile.ZipFile(npz, "w") as z:
        z.writestr("0.npy", keep)
    with pytest.raises(ValueError, match="leaves|missing"):
        restore_checkpoint(d, 0, _tree())


def test_store_surfaces_tampered_arrays(tmp_path):
    idx = SuffixArrayIndex.build(np.asarray([0, 1, 2, 1, 0]), device=CPU)
    path = str(tmp_path / "idx")
    save_index(path, idx)
    step = os.path.join(path, "step_00000000")
    data = dict(np.load(os.path.join(step, "arrays.npz")))
    data["2"] = data["2"][:2]
    np.savez(os.path.join(step, "arrays.npz"), **data)
    with pytest.raises(ValueError, match="shape"):
        load_index(path, device=CPU)


def _nested():
    return {"w": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "layers": [{"b": np.ones(2, np.float32),
                        "a": np.zeros((1, 2), np.int64)},
                       np.asarray(3.5)],
            "c": np.arange(4, dtype=np.int16)}


def test_checkpoint_format_matches_jax(tmp_path):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save_checkpoint(ours, 3, _nested(), extras={"k": 1})
    host = {"w": np.arange(6, dtype=np.int32).reshape(2, 3),
            "layers": [{"b": np.ones(2, np.float32),
                        "a": np.zeros((1, 2), np.int64)}, np.asarray(3.5)],
            "c": np.arange(4, dtype=np.int16)}
    jckpt.save_checkpoint(theirs, 3, host, extras={"k": 1})
    manifests = []
    for d in (ours, theirs):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            manifests.append(json.load(f))
        assert os.path.exists(os.path.join(d, "step_00000003", "COMMITTED"))
    for key in ("step", "paths", "shapes", "dtypes", "extras"):
        assert manifests[0][key] == manifests[1][key], key
    assert manifests[0]["treedef"] is None
    # each restores the other's checkpoint, leaf for leaf
    got, extras = restore_checkpoint(theirs, 3, host)
    back, _ = jckpt.restore_checkpoint(ours, 3, host)
    for tree in (got, back):
        assert extras == {"k": 1}
        np.testing.assert_array_equal(tree["w"], host["w"])
        np.testing.assert_array_equal(tree["layers"][0]["a"],
                                      host["layers"][0]["a"])
        assert float(tree["layers"][1]) == 3.5


def test_async_write_and_latest_step(tmp_path):
    from repro_torch.ckpt import latest_step
    d = str(tmp_path)
    assert latest_step(d) is None
    wait_for_async(save_checkpoint(d, 1, _tree(), async_write=True))
    save_checkpoint(d, 4, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # never committed
    assert latest_step(d) == 4
    tree, _ = restore_checkpoint(d, 1, _tree())
    np.testing.assert_array_equal(tree["b"], _tree()["b"])


# -------------------------------------------- warm serve (subprocesses)
def test_serve_restart_with_warm_store_skips_build(tmp_path):
    """A serve restart with a warm `IndexStore` restores instead of
    rebuilding: the second process reports a store hit and no builder
    traffic at all."""
    code = textwrap.dedent(f"""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_sa_queries
    from repro_torch.trace import counters
    run = serve_sa_queries(get_config("suffix-array"), n_chars=4000,
                           n_docs=2, n_queries=8, pattern_len=8,
                           store_dir={str(tmp_path / 'store')!r},
                           query_batch=8, device="cpu")
    print("BUILDS", counters().get("repro_torch.builds", 0),
          run.store_status)
    """)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                           capture_output=True, timeout=300)
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        outs.append(r.stdout)
    assert "index store: miss" in outs[0] and "indexed" in outs[0]
    assert "index store: hit" in outs[1] and "restored" in outs[1]
    assert "BUILDS 0 hit" in outs[1]
