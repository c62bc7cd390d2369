"""The port's segmented index (`repro_torch.api.SegmentedIndex`) and its store
held against the JAX package's (`repro.api.SegmentedIndex`) and against the
port's monolithic index: the cases of tests/api/test_segments.py — counts,
locate rows and `longest_match` equal for any segment layout, one segment
build per ingest or delete, size-tiered compaction, the staging protocol,
`QuerySession` and `SAServer` over a segmented corpus, and the
`SegmentedIndexStore` contract (incremental sync, tamper and rollback
detection).

Inputs are made with numpy from a seed; every comparison is on integers
and exact (tolerance 0). The port runs with ``device="cpu"`` on its
default plan (the torch build, the kernels' plain versions); the JAX side
builds with the "seq" backend.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest

import repro.api as japi
from repro_torch.api import (QuerySession, SAOptions, Segment,
                             SegmentedIndex, SegmentedIndexStore,
                             StaleIndexError, SuffixArrayIndex)
from repro_torch.serve import SAServer
from repro_torch.sparse import PatternTooShortError
from repro_torch.trace import counters

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
OPTS = SAOptions()
#: fanin high enough that compaction never fires — isolates ingest traffic
NO_COMPACT = SAOptions(compact_fanin=64)
JSEQ = japi.SAOptions(backend="seq")


def _builds():
    return counters().get("repro_torch.builds", 0)


def _docs(seed=0, n_docs=7, sigma=5, lo=20, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, sigma, int(rng.integers(lo, hi))).tolist()
            for _ in range(n_docs)]


def _patterns(docs):
    """Planted, random, separator-spanning and whole-document patterns."""
    rng = np.random.default_rng(99)
    pats = [d[:3] for d in docs if len(d) >= 3]
    pats += [list(rng.integers(0, 5, m)) for m in (1, 2, 4, 7)]
    a, b = docs[0], docs[1]
    if len(a) >= 2 and len(b) >= 2:
        pats.append(list(a[-2:]) + list(b[:2]))
    pats.append(list(docs[-1]))
    return pats


def _assert_equivalent(seg, mono, pats):
    """`mono` is a monolithic index (either package) or another segmented
    index (either package)."""
    np.testing.assert_array_equal(seg.count_batch(pats),
                                  mono.count_batch(pats))
    np.testing.assert_array_equal(seg.contains_batch(pats),
                                  mono.contains_batch(pats))
    for got, want in zip(seg.locate_batch(pats),
                         mono.locate_docs_batch(pats)):
        np.testing.assert_array_equal(got, want)


def _seg(docs, opts=OPTS, **kw):
    return SegmentedIndex.from_docs(docs, opts, device=CPU, **kw)


# ----------------------------------------------------- merged == monolithic
@pytest.mark.parametrize("segment_docs", [1, 2, 3, 7])
def test_segmented_equals_monolithic_and_jax(segment_docs):
    docs = _docs()
    seg = _seg(docs, segment_docs=segment_docs)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    ref = japi.SegmentedIndex.from_docs(docs, JSEQ,
                                        segment_docs=segment_docs)
    assert (seg.n, seg.n_docs, seg.n_segments) == \
        (mono.n, mono.n_docs, ref.n_segments)
    pats = _patterns(docs)
    _assert_equivalent(seg, mono, pats)
    _assert_equivalent(seg, ref, pats)
    for a, b in zip(seg.segments, ref.segments):
        assert a.seg_id == b.seg_id
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.index.sa.numpy(), b.index.sa)
    assert int(seg.count_batch([[]])[0]) == mono.n


@pytest.mark.parametrize("segment_docs", [1, 3])
def test_longest_match_matches_jax(segment_docs):
    docs = _docs(seed=4)
    seg = _seg(docs, segment_docs=segment_docs)
    ref = japi.SegmentedIndex.from_docs(docs, JSEQ,
                                        segment_docs=segment_docs)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    rng = np.random.default_rng(12)
    for seq in (docs[2][5:30] + list(rng.integers(0, 5, 10)),
                list(rng.integers(0, 5, 40)), [9, 9, 9], []):
        want = ref.longest_match(seq)
        assert seg.longest_match(seq) == want == mono.longest_match(seq)


def test_empty_docs_and_single_doc_segments():
    docs = [[1, 2, 3, 1, 2], [], [2, 2, 2], [], [0]]
    seg = _seg(docs, segment_docs=1)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    _assert_equivalent(seg, mono, [[1, 2], [2, 2], [0], [3, 1]])
    assert seg.n_docs == 5 and seg.n_segments == 5


def test_empty_corpus():
    seg = _seg([])
    assert seg.n == 0 and seg.n_docs == 0
    assert seg.count([1, 2]) == 0
    assert not seg.contains([1])
    assert seg.locate([5]).shape == (0, 2)


def test_scalar_shims_and_doc_accessor():
    docs = _docs(n_docs=4)
    seg = _seg(docs, segment_docs=2)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    p = docs[2][:4]
    assert seg.count(p) == mono.count(p)
    assert seg.contains(p) == bool(mono.contains_batch([p])[0])
    np.testing.assert_array_equal(seg.doc(2), np.asarray(docs[2]))
    np.testing.assert_array_equal(seg.locate(p), mono.locate_docs(p))
    with pytest.raises(KeyError):
        seg.doc(99)


def test_locate_rejects_empty_pattern():
    seg = _seg(_docs(n_docs=2), segment_docs=1)
    with pytest.raises(ValueError, match="empty pattern"):
        seg.locate_batch([[]])


def test_pattern_validation_matches_monolithic():
    seg = _seg(_docs(n_docs=3), segment_docs=1, sigma=5)
    with pytest.raises(ValueError, match="≥ 0"):
        seg.count([-1])
    with pytest.raises(ValueError, match="outside the corpus alphabet"):
        seg.count([7])


def test_locate_rows_are_global_and_sorted():
    seg = _seg([[1, 2, 1, 2], [2, 1, 2], [1, 2]], segment_docs=1)
    assert seg.locate([1, 2]).tolist() == [[0, 0], [0, 2], [1, 1], [2, 0]]


def test_segments_must_share_the_device():
    idx = SuffixArrayIndex.from_docs([[1, 2]], device=CPU)
    seg = Segment(seg_id="seg-000000", doc_ids=[0], index=idx)
    assert SegmentedIndex([seg], device=CPU).n_segments == 1
    with pytest.raises(ValueError, match="lives on cpu"):
        SegmentedIndex([seg], device="meta")
    with pytest.raises(ValueError, match="segment_docs"):
        _seg([[1]], segment_docs=0)


# --------------------------------------------------- ingest/delete traffic
def test_single_doc_ingest_builds_exactly_one_segment():
    seg = _seg(_docs(), NO_COMPACT, segment_docs=2)
    before = _builds()
    ids = seg.add_docs([[4, 0, 4, 0, 4]])
    assert _builds() - before == 1, "ingest must build ONE segment"
    assert ids == [7] and seg.n_docs == 8
    assert seg.count([4, 0, 4]) >= 1
    assert seg.add_docs([]) == [] and _builds() - before == 1


def test_ingest_matches_full_rebuild_and_jax():
    docs = _docs(n_docs=5)
    extra = [[0, 1, 0, 1, 0, 1], [3, 3, 3]]
    seg = _seg(docs, NO_COMPACT, segment_docs=2)
    seg.add_docs(extra)
    ref = japi.SegmentedIndex.from_docs(
        docs, japi.SAOptions(backend="seq", compact_fanin=64),
        segment_docs=2)
    ref.add_docs(extra)
    mono = SuffixArrayIndex.from_docs(docs + extra, device=CPU)
    pats = _patterns(docs + extra)
    _assert_equivalent(seg, mono, pats)
    _assert_equivalent(seg, ref, pats)


def test_delete_rebuilds_only_owning_segment():
    seg = _seg(_docs(), NO_COMPACT, segment_docs=2)
    before = _builds()
    seg.delete_doc(2)
    assert _builds() - before == 1, "delete must rebuild ONE segment"
    docs_left = [d for i, d in enumerate(_docs()) if i != 2]
    mono = SuffixArrayIndex.from_docs(docs_left, device=CPU)
    np.testing.assert_array_equal(seg.doc_ids,
                                  [i for i in range(7) if i != 2])
    np.testing.assert_array_equal(seg.count_batch(_patterns(docs_left)),
                                  mono.count_batch(_patterns(docs_left)))
    with pytest.raises(KeyError):
        seg.doc(2)


def test_delete_sole_doc_drops_segment_with_zero_builds():
    seg = _seg(_docs(n_docs=3), NO_COMPACT, segment_docs=1)
    before = _builds()
    seg.delete_doc(1)
    assert _builds() - before == 0
    assert seg.n_segments == 2 and seg.n_docs == 2


def test_doc_ids_never_reused_after_delete():
    seg = _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2)
    seg.delete_doc(3)
    assert seg.add_docs([[1, 1]]) == [4], "freed ids must not be recycled"


# ------------------------------------------------------------- compaction
def test_compaction_bounds_fanout_and_matches_jax():
    docs = _docs(n_docs=9, lo=30, hi=40)      # 9 same-tier segments
    seg = _seg(docs, SAOptions(compact_fanin=3), segment_docs=1)
    ref = japi.SegmentedIndex.from_docs(
        docs, japi.SAOptions(backend="seq", compact_fanin=3),
        segment_docs=1)
    assert seg.n_segments == 9
    merges = seg.compact()
    assert merges == ref.compact() >= 1 and seg.n_segments < 9
    assert [s.seg_id for s in seg.segments] == \
        [s.seg_id for s in ref.segments]
    _assert_equivalent(seg, SuffixArrayIndex.from_docs(docs, device=CPU),
                       _patterns(docs))


def test_ingest_stream_amortized_builds():
    rng = np.random.default_rng(5)
    seg = _seg([], SAOptions(compact_fanin=4))
    n_ingests = 12
    before = _builds()
    for _ in range(n_ingests):
        seg.add_docs([rng.integers(0, 4, 25).tolist()])
    built = _builds() - before
    assert n_ingests <= built < 2 * n_ingests
    assert seg.n_segments <= 8, "compaction must bound fan-out"
    assert seg.n_docs == n_ingests


def test_from_docs_layout_is_exact():
    seg = _seg(_docs(n_docs=6, lo=30, hi=31), SAOptions(compact_fanin=2),
               segment_docs=1)
    assert seg.n_segments == 6
    assert [len(s.doc_ids) for s in seg.segments] == [1] * 6


# ------------------------------------------------------ sparse segments
def test_sparse_segments_match_dense():
    docs = _docs(n_docs=6, lo=40, hi=80)
    seg = _seg(docs, SAOptions(sample_rate=4), segment_docs=2)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    pats = [d[3:9] for d in docs] + [docs[0][-2:] + docs[1][:2]]
    _assert_equivalent(seg, mono, pats)
    assert seg.min_pattern_len == 4
    with pytest.raises(PatternTooShortError):
        seg.count([1, 2])
    enc = [seg._encode_pattern(p) for p in pats]
    lo, hi = seg.ranges_staged(seg.stage_encoded(enc))
    assert (lo == 0).all()
    np.testing.assert_array_equal(hi, mono.count_batch(pats))


# ------------------------------------------------- serving-tier protocol
def test_staging_protocol_merges_counts():
    docs = _docs(n_docs=6)
    seg = _seg(docs, segment_docs=2)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    pats = _patterns(docs)
    enc = [seg._encode_pattern(p) for p in pats]
    lo, hi = seg.ranges_staged(seg.stage_encoded(enc))
    assert (lo == 0).all(), "segmented ranges are virtual [0, count)"
    np.testing.assert_array_equal(hi - lo, mono.count_batch(pats))


def test_query_session_over_segmented_index():
    docs = _docs(n_docs=6)
    seg = _seg(docs, segment_docs=2)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    sess = QuerySession(seg, batch_size=4)
    pats = _patterns(docs)
    np.testing.assert_array_equal(sess.count(pats), mono.count_batch(pats))
    for got, want in zip(sess.locate(pats), mono.locate_docs_batch(pats)):
        np.testing.assert_array_equal(got, want)
    assert sess.queries_served == 2 * len(pats)


def test_sa_server_over_segmented_index():
    docs = _docs(n_docs=6)
    seg = _seg(docs, segment_docs=2)
    mono = SuffixArrayIndex.from_docs(docs, device=CPU)
    pats = _patterns(docs)
    with SAServer(seg, max_batch=8, coalesce_max_wait_us=200.0) as srv:
        assert srv.warmup(pattern_lens=(4,), batch_buckets=[1, 4]) == 2
        futs = [srv.submit(p) for p in pats]
        got = [f.result(timeout=30) for f in futs]
    assert all(r.ok for r in got)
    assert [r.count for r in got] == list(mono.count_batch(pats))
    assert all(r.lo == 0 and r.hi == r.count for r in got)


# ------------------------------------------------------------ persistence
@pytest.fixture
def store(tmp_path):
    return SegmentedIndexStore(str(tmp_path / "segstore"), device=CPU)


def test_store_round_trip(store):
    docs = _docs(n_docs=5)
    seg = _seg(docs, NO_COMPACT, segment_docs=2, sigma=5)
    traffic = store.save("corpus", seg)
    assert traffic == {"segments_written": 3, "segments_deleted": 0}
    before = _builds()
    loaded = store.load("corpus", options=NO_COMPACT)
    assert _builds() - before == 0, "load must not build"
    assert loaded.device == seg.device
    _assert_equivalent(loaded, SuffixArrayIndex.from_docs(docs, device=CPU),
                       _patterns(docs))
    assert loaded.n_docs == seg.n_docs
    assert loaded._next_doc_id == seg._next_doc_id
    assert loaded._next_seg == seg._next_seg
    assert loaded.sigma == 5 and not loaded.dirty


def test_incremental_sync_writes_one_segment(store):
    seg = _seg(_docs(), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    seg.add_docs([[1, 2, 3]])
    traffic = store.save("corpus", seg)
    assert traffic == {"segments_written": 1, "segments_deleted": 0}
    loaded = store.load("corpus", options=NO_COMPACT)
    assert loaded.n_docs == 8 and loaded.count([1, 2, 3]) >= 1


def test_sync_garbage_collects_dropped_segments(store):
    docs = _docs(n_docs=6, lo=30, hi=40)
    seg = _seg(docs, SAOptions(compact_fanin=3), segment_docs=1)
    store.save("corpus", seg)
    seg.compact()
    traffic = store.save("corpus", seg)
    assert traffic["segments_deleted"] >= 2
    on_disk = set(os.listdir(os.path.join(store.path("corpus"),
                                          "segments")))
    assert on_disk == {s.seg_id for s in seg.segments}


def test_unsynced_load_only_sees_last_sync(store):
    seg = _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    seg.add_docs([[3, 3, 3, 3]])                  # NOT synced
    assert store.load("corpus", options=NO_COMPACT).n_docs == 4


def test_tampered_manifest_raises_stale(store):
    seg = _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    mpath = os.path.join(store.path("corpus"), "corpus.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["segments"][0]["n"] += 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(StaleIndexError, match="manifest records"):
        store.load("corpus", options=NO_COMPACT)


def test_tampered_segment_checkpoint_raises_stale(store):
    seg = _seg(_docs(seed=8), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    mpath = os.path.join(store.path("corpus"), "segments",
                         seg.segments[0].seg_id, "step_00000000",
                         "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["extras"]["corpus_sha256"] = "f" * 64
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(StaleIndexError, match="corpus"):
        store.load("corpus")


@pytest.mark.parametrize("edit,match", [
    ("{not json", "unreadable"),
    ('{"kind": "lm", "format": 1}', "not a segmented"),
    ('{"kind": "segmented-suffix-array-index", "format": 9}', "format"),
])
def test_corrupt_manifest_raises_stale(store, edit, match):
    store.save("corpus", _seg(_docs(n_docs=2), NO_COMPACT))
    with open(os.path.join(store.path("corpus"), "corpus.json"), "w") as f:
        f.write(edit)
    with pytest.raises(StaleIndexError, match=match):
        store.load("corpus")


def test_rolled_back_segment_raises_stale(store):
    seg = _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    victim = seg.segments[0]
    seg.dirty.add(victim.seg_id)
    store.save("corpus", seg)
    assert victim.version == 1
    spath = os.path.join(store.path("corpus"), "segments", victim.seg_id)
    shutil.rmtree(os.path.join(spath, "step_00000001"))
    with pytest.raises(StaleIndexError, match="rolled back"):
        store.load("corpus", options=NO_COMPACT)


def test_missing_segment_raises_stale(store):
    seg = _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2)
    store.save("corpus", seg)
    shutil.rmtree(os.path.join(store.path("corpus"), "segments",
                               seg.segments[0].seg_id))
    with pytest.raises(StaleIndexError, match="missing segment"):
        store.load("corpus", options=NO_COMPACT)


def test_options_fingerprint_mismatch_raises_stale(store):
    store.save("corpus", _seg(_docs(n_docs=2), NO_COMPACT))
    with pytest.raises(StaleIndexError, match="plan"):
        store.load("corpus", options=SAOptions(v0=7))
    with pytest.raises(FileNotFoundError):
        store.load("absent")


def test_segmentation_knobs_do_not_invalidate(store):
    store.save("corpus", _seg(_docs(n_docs=4), NO_COMPACT, segment_docs=2))
    relayout = SAOptions(compact_fanin=2, segment_docs=1)
    assert store.load("corpus", options=relayout).compact_fanin == 2


def test_get_or_build_statuses_and_stats(store):
    docs = _docs(n_docs=4)
    build = lambda: _seg(docs, NO_COMPACT, segment_docs=2)  # noqa: E731
    assert store.get_or_build("corpus", build, options=NO_COMPACT)[1] == \
        "miss"
    assert store.get_or_build("corpus", build, options=NO_COMPACT)[1] == \
        "hit"
    assert store.get_or_build("corpus", build,
                              options=SAOptions(v0=7))[1] == "stale"
    s = store.stats()
    assert (s["entries"], s["hits"], s["misses"], s["stale"]) == (1, 1, 1, 1)
    assert store.entries() == ["corpus"]


def test_invalid_entry_and_segment_ids(store):
    with pytest.raises(ValueError):
        store.path("../escape")
    with pytest.raises(StaleIndexError):
        store._segment_path("corpus", "nope/../../etc")


# ------------------------------------------------- subprocess warm restart
_PHASE = r"""
import json, sys
from repro_torch.api import SAOptions, SegmentedIndex, SegmentedIndexStore
from repro_torch.trace import counters

root, phase = sys.argv[1], sys.argv[2]
opts = SAOptions(compact_fanin=64)
docs = [[1, 2, 3, 1, 2], [2, 2, 2, 0], [0, 1, 0, 1, 0]]
store = SegmentedIndexStore(root, device="cpu")

def builds():
    return counters().get("repro_torch.builds", 0)

if phase == "build":
    sidx = SegmentedIndex.from_docs(docs, opts, segment_docs=1, device="cpu")
    out = {"builds": builds(), **store.save("corpus", sidx)}
elif phase == "ingest":
    b0 = builds()
    sidx, status = store.get_or_build(
        "corpus", lambda: (_ for _ in ()).throw(AssertionError("rebuilt!")),
        options=opts)
    load_builds = builds() - b0
    sidx.add_docs([[3, 3, 3, 3]])
    out = {"status": status, "load_builds": load_builds,
           "ingest_builds": builds() - b0 - load_builds,
           **store.save("corpus", sidx)}
else:
    b0 = builds()
    sidx = store.load("corpus", options=opts)
    out = {"load_builds": builds() - b0, "n_docs": sidx.n_docs,
           "count": int(sidx.count([3, 3, 3, 3]))}
print(json.dumps(out))
"""


def _run_phase(root, phase):
    proc = subprocess.run(
        [sys.executable, "-c", _PHASE, str(root), phase],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(root)})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_warm_restart_across_processes(tmp_path):
    root = tmp_path / "segstore"
    p1 = _run_phase(root, "build")
    assert p1["builds"] == 3 and p1["segments_written"] == 3
    p2 = _run_phase(root, "ingest")
    assert p2["status"] == "hit" and p2["load_builds"] == 0
    assert p2["ingest_builds"] == 1 and p2["segments_written"] == 1
    p3 = _run_phase(root, "verify")
    assert p3 == {"load_builds": 0, "n_docs": 4, "count": 1}
