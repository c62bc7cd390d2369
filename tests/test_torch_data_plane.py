"""The port's training data plane (`repro_torch.data.pipeline`) held against
the JAX package's (`repro.data.pipeline`): the cases of
tests/train/test_data_plane.py that need no train step and of
tests/sparse/test_sparse_data_plane.py.

Streamed bytes equal `repro`'s streamed bytes and the port's and `repro`'s
monolithic `dedup_docs` for every sharding; each shard is one segment
build; gate hits, contaminated masks, gated batches (`tokens`,
`loss_mask`, both policies) and `gate_stats`, probe dicts,
`TokenPipeline` batches, `PipelineConfig` errors and
`SAConfig.to_pipeline()` equal `repro`'s; a sparse plane equals a dense
one. Inputs are made with numpy from a seed; every comparison is exact
(tolerance 0). The port runs with ``device="cpu"``; `repro`'s outputs are
computed once per module in fixtures.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.data.pipeline as jpipe
import repro.text.dedup as jdedup
from repro.configs import get_config as jget_config
from repro_torch.api import SAOptions, SegmentedIndex, SuffixArrayIndex
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (ContaminationGate, PipelineConfig,
                                       StreamingDedup, TokenPipeline,
                                       TrainingDataPlane, synthetic_corpus,
                                       synthetic_doc_shards)
from repro_torch.text.dedup import DEDUP_MIN_LEN, dedup_docs
from repro_torch.trace import counters

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
VOCAB = 64
MIN_LEN = 24
RATE = 8
SHARDINGS = (1, 4, 16)


def _builds() -> int:
    return counters().get("repro_torch.builds", 0)


def make_shards(n_chars=18_000, shard_docs=4, doc_len=1200, dup=0.4, seed=3):
    return synthetic_doc_shards(n_chars, VOCAB, shard_docs=shard_docs,
                                doc_len=doc_len, dup_fraction=dup, seed=seed)


def _same_docs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def _pair(cfg_kw, **kw):
    """(port plane, JAX plane) over the same config fields and inputs."""
    ours = TrainingDataPlane(PipelineConfig(**cfg_kw), device=CPU, **kw)
    theirs = jpipe.TrainingDataPlane(jpipe.PipelineConfig(**cfg_kw), **kw)
    return ours, theirs


@pytest.fixture(scope="module")
def jax_streams():
    """`repro`'s streamed kept docs, report and per-shard stats for each
    sharding, and its monolithic `dedup_docs` of the same corpus."""
    out = {}
    for shard_docs in SHARDINGS:
        plane = jpipe.TrainingDataPlane(
            jpipe.PipelineConfig(dedup=True, dedup_min_len=MIN_LEN,
                                 vocab=VOCAB),
            shards=make_shards(shard_docs=shard_docs))
        out[shard_docs] = (plane._kept, dataclasses.asdict(plane.report),
                           [dataclasses.asdict(s) for s in plane.shard_stats])
    docs = [d for s in make_shards() for d in s]
    out["mono"] = jdedup.dedup_docs(docs, min_len=MIN_LEN, sigma=VOCAB)
    return out


@pytest.fixture(scope="module")
def port_mono():
    docs = [d for s in make_shards() for d in s]
    return dedup_docs(docs, min_len=MIN_LEN, sigma=VOCAB, device=CPU)


# ---------------------------------------------------------- streaming dedup
@pytest.mark.parametrize("shard_docs", SHARDINGS)
def test_streaming_dedup_byte_identical_to_monolithic(shard_docs, jax_streams,
                                                      port_mono):
    """Any sharding streams to the bytes of the whole-corpus `dedup_docs`,
    the port's and `repro`'s, and to `repro`'s stream of the same shards."""
    shards = make_shards(shard_docs=shard_docs)
    plane = TrainingDataPlane(
        PipelineConfig(dedup=True, dedup_min_len=MIN_LEN, vocab=VOCAB),
        shards=shards, device=CPU)
    mono, rep = port_mono
    jkept, jreport, jstats = jax_streams[shard_docs]
    jmono, jrep = jax_streams["mono"]
    assert rep.dropped_chars > 0
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    _same_docs(plane._kept, mono)
    _same_docs(plane._kept, jkept)
    _same_docs(mono, jmono)
    assert dataclasses.asdict(plane.report) == jreport
    assert [dataclasses.asdict(s) for s in plane.shard_stats] == jstats
    assert plane.report.dropped_chars == rep.dropped_chars
    assert plane.report.kept_chars == sum(len(d) for d in mono)


def test_streaming_dedup_one_segment_build_per_shard(jax_streams):
    shards = make_shards(shard_docs=4)
    plane = TrainingDataPlane(
        PipelineConfig(dedup=True, dedup_min_len=MIN_LEN, vocab=VOCAB),
        device=CPU)
    for shard in shards:
        before = _builds()
        st = plane.ingest_shard(shard)
        assert _builds() - before == 1
        assert st.builds == 1
    assert plane.report.builds == len(shards)
    assert len(plane.index.segments) == len(shards)
    assert [dataclasses.asdict(s) for s in plane.shard_stats] == \
        jax_streams[4][2]


def test_compaction_adds_its_merges_to_the_shard_builds():
    """`compact_every` merges count as builds on top of the one per shard;
    the kept bytes do not change."""
    shards = make_shards(n_chars=9_600, shard_docs=1)
    cfg = dict(dedup=True, dedup_min_len=MIN_LEN, vocab=VOCAB,
               options=SAOptions(compact_fanin=2))
    flat = TrainingDataPlane(PipelineConfig(**cfg), shards=shards,
                             device=CPU)
    merged = TrainingDataPlane(PipelineConfig(**cfg, compact_every=2),
                               device=CPU)
    merges = []
    for shard in shards:
        n_seg = merged.index.n_segments
        st = merged.ingest_shard(shard)
        merges.append(n_seg + 1 - merged.index.n_segments)
        assert st.builds == 1 + merges[-1]
    assert sum(merges) > 0 and merged.index.n_segments < len(shards)
    _same_docs(merged._kept, flat._kept)


def test_streaming_dedup_cross_shard_only_duplicates():
    rng = np.random.default_rng(7)
    a = rng.integers(0, VOCAB, 2000)
    fresh = rng.integers(0, VOCAB, 100)
    cfg = dict(dedup=True, dedup_min_len=MIN_LEN, vocab=VOCAB)
    plane, jplane = _pair(cfg)
    for p in (plane, jplane):
        p.ingest_shard([a])
    st = plane.ingest_shard([np.concatenate([a[500:800], fresh])])
    jst = jplane.ingest_shard([np.concatenate([a[500:800], fresh])])
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.prior_hits > 0 and st.dropped_chars >= 300
    np.testing.assert_array_equal(plane._kept[1], fresh)
    _same_docs(plane._kept, jplane._kept)


def test_plane_without_dedup_keeps_raw_bytes():
    shards = make_shards(shard_docs=4, dup=0.0)
    plane, jplane = _pair({"vocab": VOCAB}, shards=shards)
    assert plane.index is None
    assert plane.report.dropped_chars == 0
    assert plane.n == jplane.n == sum(len(d) for s in shards for d in s)
    np.testing.assert_array_equal(plane.corpus, jplane.corpus)
    assert plane.corpus.dtype == jplane.corpus.dtype


# ------------------------------------------------------- contamination gate
def eval_and_control():
    rng = np.random.default_rng(11)
    eval_docs = [rng.integers(0, 32, 2000) for _ in range(3)]
    control = rng.integers(32, 64, size=(16, 3 * MIN_LEN))
    return eval_docs, control


def test_gate_flags_all_planted_none_disjoint():
    eval_docs, control = eval_and_control()
    gate = ContaminationGate(eval_docs, min_len=MIN_LEN, sigma=VOCAB,
                             device=CPU)
    jgate = jpipe.ContaminationGate(eval_docs, min_len=MIN_LEN, sigma=VOCAB)
    planted = control.copy()
    for i in range(len(planted)):
        src = int(i * 37 % (len(eval_docs[0]) - MIN_LEN))
        planted[i, 5:5 + MIN_LEN] = eval_docs[0][src:src + MIN_LEN]
    (hits_p, mask_p), (hits_c, mask_c) = (gate.check(planted),
                                          gate.check(control))
    for got, windows in (((hits_p, mask_p), planted),
                         ((hits_c, mask_c), control)):
        for a, b in zip(got, jgate.check(windows)):
            np.testing.assert_array_equal(a, b)
    assert gate.stats == jgate.stats
    assert (hits_p > 0).all() and (hits_c == 0).all() and not mask_c.any()
    assert mask_p[:, 5:5 + MIN_LEN].all() and not mask_p[:, :5].any()


@pytest.fixture(scope="module")
def gated_jax():
    """`repro`'s batches of steps 0..3 under each policy, and its stats."""
    eval_docs, _ = eval_and_control()
    out = {}
    for policy, doc in (("reject", _reject_doc(eval_docs)),
                        ("mask", _mask_doc(eval_docs))):
        cfg = jpipe.PipelineConfig(**_gate_cfg(policy))
        plane = jpipe.TrainingDataPlane(cfg, eval_docs=eval_docs,
                                        shards=[[doc]])
        batches = [plane.batch_at(step) for step in range(4)]
        out[policy] = (batches, plane.gate_stats())
    return out


def _reject_doc(eval_docs):
    rng = np.random.default_rng(12)
    doc = rng.integers(32, 64, 6000)
    doc[1000:3000] = np.concatenate([eval_docs[0], eval_docs[0]])[:2000]
    return doc


def _mask_doc(eval_docs):
    rng = np.random.default_rng(13)
    doc = rng.integers(32, 64, 4000)
    doc[:2000] = eval_docs[0]
    return doc


def _gate_cfg(policy):
    return dict(seq_len=48, global_batch=8 if policy == "reject" else 16,
                gate_min_len=MIN_LEN, gate_policy=policy, vocab=VOCAB,
                seed=5 if policy == "reject" else 0)


def test_gate_reject_policy_resamples_deterministically(gated_jax):
    eval_docs, _ = eval_and_control()
    doc = _reject_doc(eval_docs)
    cfg = PipelineConfig(**_gate_cfg("reject"))
    p1 = TrainingDataPlane(cfg, eval_docs=eval_docs, shards=[[doc]],
                           device=CPU)
    p2 = TrainingDataPlane(cfg, eval_docs=eval_docs, shards=[[doc]],
                           device=CPU)
    jbatches, jstats = gated_jax["reject"]
    for step in range(4):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        _same_batch(b1, b2)
        _same_batch(b1, jbatches[step])
    assert p1.gate.stats["rejected_windows"] > 0
    assert p1.gate.stats == p2.gate.stats
    assert p1.gate_stats() == jstats


def test_gate_mask_policy_zeroes_contaminated_targets(gated_jax):
    eval_docs, _ = eval_and_control()
    doc = _mask_doc(eval_docs)
    plane = TrainingDataPlane(PipelineConfig(**_gate_cfg("mask")),
                              eval_docs=eval_docs, shards=[[doc]],
                              device=CPU)
    jbatches, jstats = gated_jax["mask"]
    batches = [plane.batch_at(step) for step in range(4)]
    for got, want in zip(batches, jbatches):
        _same_batch(got, want)
    assert plane.gate_stats() == jstats
    b = batches[0]
    assert b["loss_mask"].shape == (16, 48)
    assert b["loss_mask"].dtype == np.float32
    assert plane.gate.stats["masked_windows"] > 0
    assert plane.gate.check(doc[None, :49])[0][0] > 0
    assert b["loss_mask"].min() == 0.0


# ----------------------------------------------------------- probe metrics
def test_longest_match_monolithic_and_segmented():
    rng = np.random.default_rng(21)
    docs = [rng.integers(0, VOCAB, 1000) for _ in range(4)]
    mono = SuffixArrayIndex.from_docs(docs, sigma=VOCAB, device=CPU)
    seg = SegmentedIndex.from_docs(docs, segment_docs=2, sigma=VOCAB,
                                   device=CPU)
    jmono = japi.SuffixArrayIndex.from_docs(
        docs, japi.SAOptions(backend="seq"), sigma=VOCAB)
    verbatim = docs[1][200:500]
    fresh = rng.integers(0, VOCAB, 300)
    weird = np.concatenate([verbatim[:50], [VOCAB + 7], verbatim[:50]])
    seqs = (verbatim, fresh, np.zeros(0, np.int64), weird)
    want = [jmono.longest_match(s) for s in seqs]
    assert want[0] == 300 and want[1] < MIN_LEN and want[2] == 0 \
        and want[3] == 50
    for idx in (mono, seg):
        assert [idx.longest_match(s) for s in seqs] == want


def test_plane_probe_reports_copy_metrics():
    shards = make_shards(shard_docs=8)
    cfg = dict(dedup=True, dedup_min_len=MIN_LEN, vocab=VOCAB)
    plane, jplane = _pair(cfg, shards=shards)
    excerpt = shards[0][0][100:340]
    fresh = np.random.default_rng(22).integers(0, VOCAB, 240)
    m = plane.probe([excerpt, fresh], min_len=100)
    assert m == jplane.probe([excerpt, fresh], min_len=100)
    assert m["samples"] == 2 and m["longest_copy_max"] >= 240
    assert m["frac_memorized"] == 0.5
    assert plane.probe([]) == jplane.probe([])
    with pytest.raises(RuntimeError, match="no training index"):
        TrainingDataPlane(PipelineConfig(vocab=VOCAB),
                          device=CPU).probe([excerpt])


# ------------------------------------------------ legacy facade and config
@pytest.mark.parametrize("dedup", [False, True])
def test_token_pipeline_facade_matches_jax(dedup):
    corpus = synthetic_corpus(16_000, vocab=VOCAB, dup_fraction=0.3, seed=1)
    np.testing.assert_array_equal(
        corpus, jpipe.synthetic_corpus(16_000, vocab=VOCAB,
                                       dup_fraction=0.3, seed=1))
    kw = dict(seq_len=32, global_batch=4, seed=9, dedup=dedup,
              dedup_min_len=MIN_LEN)
    pipe = TokenPipeline(corpus, PipelineConfig(**kw), device=CPU)
    jpipe_ = jpipe.TokenPipeline(corpus, jpipe.PipelineConfig(**kw))
    np.testing.assert_array_equal(pipe.corpus, jpipe_.corpus)
    assert (pipe.n, pipe.window, pipe.n_windows) == \
        (jpipe_.n, jpipe_.window, jpipe_.n_windows)
    for step in (0, 3, 17):
        _same_batch(pipe.batch_at(step), jpipe_.batch_at(step))
    if dedup:
        assert dataclasses.asdict(pipe.dedup_report) == \
            dataclasses.asdict(jpipe_.dedup_report)
        assert pipe.dedup_report.dropped_chars > 0
        return
    np.testing.assert_array_equal(pipe.corpus, corpus)
    rng = np.random.default_rng(np.random.SeedSequence([9, 3]))
    starts = rng.integers(0, max(1, len(corpus) - 33), size=4)
    want = np.stack([corpus[s:s + 33] for s in starts])
    got = pipe.batch_at(3)
    assert set(got) == {"tokens"}
    np.testing.assert_array_equal(got["tokens"], want)
    first = next(iter(pipe))
    _same_batch(first, pipe.batch_at(0))


def test_pipeline_config_and_generators_match_jax():
    ours, theirs = PipelineConfig(), jpipe.PipelineConfig()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.wants_index is False
    with pytest.raises(ValueError, match="unknown gate_policy"):
        PipelineConfig(gate_policy="drop")
    shards = synthetic_doc_shards(10_000, VOCAB, shard_docs=3, doc_len=700,
                                  dup_fraction=0.2, seed=4)
    jshards = jpipe.synthetic_doc_shards(10_000, VOCAB, shard_docs=3,
                                         doc_len=700, dup_fraction=0.2,
                                         seed=4)
    assert [len(s) for s in shards] == [len(s) for s in jshards]
    _same_docs([d for s in shards for d in s], [d for s in jshards for d in s])


def test_sa_config_to_pipeline_matches_jax_field_for_field():
    ours = get_config("suffix-array")
    theirs = jget_config("suffix-array")
    for name in ("dedup_min_len", "gate_min_len", "gate_policy"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert ours.dedup_min_len == DEDUP_MIN_LEN
    for kw in ({}, {"seq_len": 64, "global_batch": 2, "dedup": False,
                    "vocab": 256, "seed": 3}):
        got, want = ours.to_pipeline(**kw), theirs.to_pipeline(**kw)
        assert isinstance(got, PipelineConfig)
        for f in dataclasses.fields(want):
            if f.name == "options":
                assert got.options.fingerprint() == \
                    want.options.fingerprint()
            else:
                assert getattr(got, f.name) == getattr(want, f.name), f.name


# ------------------------------------------ tests/sparse/test_sparse_data_plane
@pytest.mark.parametrize("make", [PipelineConfig, jpipe.PipelineConfig])
def test_pipeline_config_rejects_rate_above_dedup_gram(make):
    opts = (SAOptions if make is PipelineConfig else japi.SAOptions)
    with pytest.raises(ValueError, match="dedup_min_len") as ours:
        make(dedup=True, dedup_min_len=8, options=opts(sample_rate=16))
    with pytest.raises(ValueError, match="gate_min_len") as gate:
        make(dedup_min_len=32, gate_min_len=8, options=opts(sample_rate=16))
    make(dedup=True, dedup_min_len=16, gate_min_len=16,
         options=opts(sample_rate=16))
    if make is PipelineConfig:
        for err, kw in ((ours, dict(dedup=True, dedup_min_len=8)),
                        (gate, dict(dedup_min_len=32, gate_min_len=8))):
            with pytest.raises(ValueError) as want:
                jpipe.PipelineConfig(**kw,
                                     options=japi.SAOptions(sample_rate=16))
            assert str(err.value) == str(want.value)


def test_sa_config_to_pipeline_carries_the_guard():
    cfg = get_config("suffix-array")
    bad = type(cfg)(**{**cfg.__dict__, "sample_rate": 64,
                       "dedup_min_len": 48})
    with pytest.raises(ValueError, match="dedup_min_len"):
        bad.to_pipeline()
    ok = type(cfg)(**{**cfg.__dict__, "sample_rate": 16})
    assert ok.to_pipeline().options.sample_rate == 16


def test_streaming_dedup_and_gate_validate_directly():
    seg = SegmentedIndex(options=SAOptions(sample_rate=16), sigma=VOCAB,
                         device=CPU)
    with pytest.raises(ValueError, match="sample_rate"):
        StreamingDedup(seg, min_len=8)
    with pytest.raises(ValueError, match="min_len must be"):
        StreamingDedup(seg, min_len=0)
    with pytest.raises(ValueError, match="minimum answerable"):
        ContaminationGate([np.arange(64) % 7], min_len=8,
                          options=SAOptions(sample_rate=16), sigma=VOCAB,
                          device=CPU)


def test_sparse_plane_byte_identical_to_dense():
    shards = make_shards(n_chars=18_000, doc_len=900)
    rng = np.random.default_rng(11)
    eval_docs = [rng.integers(0, 32, 1500) for _ in range(2)]

    def build(rate, make=TrainingDataPlane, cfg=PipelineConfig,
              opts=SAOptions, **kw):
        c = cfg(seq_len=96, global_batch=4, dedup=True,
                dedup_min_len=MIN_LEN, gate_min_len=MIN_LEN, vocab=VOCAB,
                seed=5, options=opts(sample_rate=rate))
        return make(c, eval_docs=eval_docs, shards=shards, **kw)

    dense, sparse = build(1, device=CPU), build(RATE, device=CPU)
    jdense = build(1, jpipe.TrainingDataPlane, jpipe.PipelineConfig,
                   japi.SAOptions)
    assert sparse.index.options.sample_rate == RATE
    assert sparse.index.min_pattern_len == RATE
    assert dense.report.dropped_chars > 0
    assert sparse.report.dropped_chars == dense.report.dropped_chars
    _same_docs(sparse._kept, dense._kept)
    _same_docs(dense._kept, jdense._kept)
    for step in range(4):
        ba, bb = sparse.batch_at(step), dense.batch_at(step)
        _same_batch(ba, bb)
        _same_batch(bb, jdense.batch_at(step))
    m = sparse.probe([sparse._kept[0][:MIN_LEN * 2],
                      np.full(MIN_LEN, VOCAB - 1)])
    assert m["samples"] == 2 and m["longest_copy_max"] >= MIN_LEN


# ------------------------------------------------------------ device rules
def test_data_plane_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TrainingDataPlane(PipelineConfig()),
                 lambda: ContaminationGate([np.arange(60) % 5]),
                 lambda: TokenPipeline(np.arange(100) % 5,
                                       PipelineConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    plane = TrainingDataPlane(PipelineConfig(dedup=True), device=CPU)
    assert plane.index.device == torch.device(CPU)


def test_import_data_plane_loads_no_jax():
    code = ("import sys, repro_torch.data.pipeline, repro_torch.text.dedup, "
            "repro_torch.text.corpus_sa, repro_torch.configs; "
            "repro_torch.configs.get_config('suffix-array').to_pipeline(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
