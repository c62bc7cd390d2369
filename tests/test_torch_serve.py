"""The port's serving tier (`repro_torch.serve`,
`repro_torch.api.QuerySession`, `repro_torch.configs`,
`repro_torch.launch.serve`) held against the JAX
package's: admission decisions, coalescer windows, seeded arrivals and SLO
summaries equal to `repro.serve` on the same inputs; `SAServer` over a
dense, a sparse and a segmented port index with every response equal to
`count_batch`; the server's admission, lifecycle and GC cases of
tests/serve/test_server.py; `QuerySession` ticks and latency summary; and
`serve_sa_queries(..., device="cpu")` against the JAX package's for the
same seed.

Inputs are made with numpy from a seed; counts and schedules are compared
exactly (tolerance 0). The port runs with ``device="cpu"``.
"""
import dataclasses
import gc
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.serve as jserve
from repro.configs import get_config as jget_config
from repro.launch.serve import serve_sa_queries as jserve_sa_queries
from repro_torch import serve
from repro_torch.api import (QuerySession, SAOptions, SegmentedIndex,
                             SuffixArrayIndex, clear_query_cache,
                             query_cache_stats, stage_batch)
from repro_torch.api.query import QueryBatch
from repro_torch.configs import SAConfig, get_config, model_archs
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (AdmissionController, Coalescer, PendingQuery,
                               Response, SAServer, make_arrivals,
                               run_open_loop, summarize)

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
SIGMA = 4
WAIT_US = 500.0
WAIT_S = WAIT_US * 1e-6


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(3)
    return SuffixArrayIndex.build(rng.integers(0, SIGMA, 400), sigma=SIGMA,
                                  device=CPU)


def _corpus(seed=7, n_docs=6, sigma=6):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, sigma, int(rng.integers(60, 160)))
            for _ in range(n_docs)]
    pats = [d[a:a + m] for d, a, m in zip(docs, (3, 10, 0, 7, 20, 1),
                                          (8, 9, 12, 16, 8, 30))]
    pats += [rng.integers(0, sigma, m) for m in (8, 10, 17, 33)]
    return docs, pats


# -------------------------------------------------------------- admission
_ADMIT_CASES = [
    # (queue_depth, policy, max_age_us, queued, oldest_age_us, est_us)
    (1, "none", None, 10 ** 6, 10 ** 9, None),
    (4, "reject", None, 3, 0.0, None),
    (4, "reject", None, 4, 0.0, 250.0),
    (1, "reject", None, 1, 0.0, None),
    (1, "reject", None, 0, 10.0, None),
    (1024, "reject", 1000.0, 1, 999.0, None),
    (1024, "reject", 1000.0, 1, 1001.0, 3.0),
    (2, "shed", None, 2, 0.0, None),
    (2, "shed", 10.0, 0, 11.0, 5.0),
]


@pytest.mark.parametrize("case", _ADMIT_CASES)
def test_admission_decisions_match_jax(case):
    depth, policy, age, queued, oldest, est = case
    ours = AdmissionController(queue_depth=depth, policy=policy,
                               max_age_us=age).admit(queued, oldest, est)
    theirs = jserve.AdmissionController(
        queue_depth=depth, policy=policy, max_age_us=age).admit(
        queued, oldest, est)
    assert (ours.action, ours.retry_after_us, ours.accepted) == \
        (theirs.action, theirs.retry_after_us, theirs.accepted)


def test_admission_validation():
    assert serve.POLICIES == jserve.POLICIES == ("none", "reject", "shed")
    with pytest.raises(ValueError, match="policy"):
        AdmissionController(policy="drop")
    with pytest.raises(ValueError, match="queue_depth"):
        AdmissionController(queue_depth=0)


# -------------------------------------------------------------- coalescer
def _script(kind):
    """(max_batch, max_wait_us, [(op, args)]) replayed on both packages."""
    if kind == "straggler":
        return 64, WAIT_US, [("add", (0, 8, 0.0)), ("pop", (WAIT_S * .99,)),
                             ("pop", (WAIT_S,))]
    if kind == "ride_along":
        return 64, WAIT_US, [("add", (0, 8, 0.0)),
                             ("add", (1, 8, WAIT_S * 0.9)),
                             ("pop", (WAIT_S,))]
    if kind == "burst":
        return 16, WAIT_US, ([("add", (i, 8, 0.0)) for i in range(41)]
                             + [("pop", (0.0,)), ("pop", (WAIT_S,))])
    if kind == "mixed_lengths":
        return 64, WAIT_US, [("add", (0, 4, 0.0)), ("add", (1, 100, 0.0)),
                             ("add", (2, 8, 0.0)), ("pop", (WAIT_S,))]
    if kind == "full_bucket":
        return 8, 1e9, [("add", (i, 8, 0.0)) for i in range(8)] + \
            [("pop", (0.0,))]
    if kind == "flush":
        return 64, 1e9, [("add", (0, 8, 0.0)), ("add", (1, 100, 0.0)),
                         ("flush", (0.0,))]
    if kind == "shed":
        return 64, WAIT_US, [("add", (0, 8, 2.0)), ("add", (1, 100, 1.0)),
                             ("shed", ()), ("shed", ()), ("shed", ())]
    assert kind == "bookkeeping"
    return 5, WAIT_US, [("age", (123.0,)), ("add", (0, 8, 1.0)),
                        ("age", (1.0 + 200e-6,)), ("deadline", ())]


def _replay(cls, pending, script):
    max_batch, wait_us, ops = script
    c = cls(max_batch=max_batch, max_wait_us=wait_us)
    log = [c.max_batch]
    for op, args in ops:
        if op == "add":
            rid, length, t = args
            c.add(pending(req_id=rid, pattern=np.zeros(length, np.int64),
                          t_arrival=t))
        elif op in ("pop", "flush"):
            out = c.pop_ready(args[0], flush=op == "flush")
            log.append([[(r.req_id, r.len_bucket) for r in b] for b in out])
        elif op == "shed":
            victim = c.shed_oldest()
            log.append(None if victim is None else victim.req_id)
        elif op == "age":
            log.append(c.oldest_age_us(args[0]))
        else:
            log.append(c.next_deadline())
        log.append(c.pending_count())
    return log


@pytest.mark.parametrize("kind", ["straggler", "ride_along", "burst",
                                  "mixed_lengths", "full_bucket", "flush",
                                  "shed", "bookkeeping"])
def test_coalescer_windows_match_jax(kind):
    script = _script(kind)
    assert _replay(Coalescer, PendingQuery, script) == \
        _replay(jserve.Coalescer, jserve.PendingQuery, script)


def test_coalescer_validation():
    with pytest.raises(ValueError):
        Coalescer(max_batch=0)
    with pytest.raises(ValueError):
        Coalescer(max_wait_us=-1.0)


# ---------------------------------------------------------------- loadgen
@pytest.mark.parametrize("process", serve.ARRIVALS)
@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_match_jax(process, seed):
    a = make_arrivals(process, 500.0, 0.5, seed=seed)
    np.testing.assert_array_equal(
        a, jserve.make_arrivals(process, 500.0, 0.5, seed=seed))
    assert np.all(np.diff(a) >= 0) and a.size and a[-1] < 0.5
    b = make_arrivals("onoff", 1000.0, 1.0, seed=seed, on_ms=20.0,
                      off_ms=80.0)
    np.testing.assert_array_equal(b, jserve.make_arrivals(
        "onoff", 1000.0, 1.0, seed=seed, on_ms=20.0, off_ms=80.0))


def test_arrival_validation():
    with pytest.raises(ValueError, match="arrival process"):
        make_arrivals("lognormal", 100.0, 1.0)
    with pytest.raises(ValueError):
        make_arrivals("poisson", 0.0, 1.0)
    with pytest.raises(ValueError):
        make_arrivals("poisson", 100.0, -1.0)


def _responses(module, statuses):
    rng = np.random.default_rng(1)
    out = []
    for i, st in enumerate(statuses):
        t = float(rng.integers(10, 5000))
        out.append(module.Response(
            req_id=i, status=st, count=i if st == "ok" else None,
            retry_after_us=5.0 if st == "rejected" else None,
            queue_us=t / 4 if st == "ok" else None,
            service_us=t / 2 if st == "ok" else None, total_us=t))
    return out


@pytest.mark.parametrize("statuses", [
    ["ok"] * 9 + ["rejected", "shed", "ok"],
    ["rejected"] * 4,
    [],
])
def test_summarize_matches_jax(statuses):
    ours = summarize(_responses(serve, statuses), 0.25)
    assert ours == jserve.summarize(_responses(jserve, statuses), 0.25)
    if "ok" not in statuses:
        assert ours["p99_ms"] is None and ours["max_ms"] is None


def test_histogram_and_metrics_match_jax():
    vals = np.random.default_rng(2).random(101) * 1e3
    ours, theirs = serve.Histogram("x"), jserve.Histogram("x")
    assert ours.summary() == theirs.summary()      # absent, never 0
    ours.extend(vals)
    theirs.extend(vals)
    assert ours.summary() == theirs.summary() and ours.count == 101
    m, jm = serve.ServeMetrics(), jserve.ServeMetrics()
    for metrics in (m, jm):
        metrics.record_batch(3, 4)
        metrics.bump("accepted", 3)
    assert m.snapshot() == jm.snapshot()


def test_run_open_loop_serves_every_arrival_in_order(index):
    rng = np.random.default_rng(5)
    pats = [rng.integers(0, SIGMA, 8) for _ in range(5)]
    with SAServer(index, max_batch=8, coalesce_max_wait_us=500.0) as srv:
        srv.warmup(pattern_lens=(8,))
        arrivals = make_arrivals("uniform", 400.0, 0.1, seed=0)
        responses = run_open_loop(srv, pats, arrivals, tick_s=0.001)
    assert len(responses) == arrivals.size
    assert [r.req_id for r in responses] == sorted(r.req_id
                                                   for r in responses)
    want = index.count_batch(pats)
    for i, r in enumerate(responses):
        assert r.ok and r.count == want[i % len(pats)]
    s = summarize(responses, 0.1)
    assert s["ok"] == len(responses) and s["rejected"] == 0
    assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]
    with pytest.raises(ValueError, match="pattern"):
        run_open_loop(srv, [], arrivals)


# ------------------------------------------------- SAServer over indexes
def _serving_indexes(docs):
    return {
        "dense": SuffixArrayIndex.from_docs(docs, device=CPU),
        "sparse": SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=4),
                                             device=CPU),
        "segmented": SegmentedIndex.from_docs(docs, segment_docs=2,
                                              device=CPU),
    }


@pytest.mark.parametrize("kind", ["dense", "sparse", "segmented"])
def test_server_responses_equal_count_batch(kind):
    docs, pats = _corpus()
    idx = _serving_indexes(docs)[kind]
    ref = japi.SuffixArrayIndex.from_docs(docs, japi.SAOptions(
        backend="seq"))
    with SAServer(idx, max_batch=4, coalesce_max_wait_us=200.0) as srv:
        srv.warmup(pattern_lens=(8, 32))
        futs = [srv.submit(p) for p in pats * 3]
        got = [f.result(timeout=60.0) for f in futs]
    want = idx.count_batch(pats * 3)
    np.testing.assert_array_equal(want, ref.count_batch(pats * 3))
    assert all(r.ok for r in got)
    assert [r.count for r in got] == want.tolist()
    assert all(r.hi - r.lo == r.count for r in got)
    assert all(r.queue_us >= 0 and r.service_us > 0 and
               r.total_us >= r.queue_us for r in got)
    assert len({r.req_id for r in got}) == len(got)
    if kind != "dense":
        assert all(r.lo == 0 for r in got)


def test_staged_path_equals_unstaged(index):
    pats = [[0, 1], [2], [3, 3, 3], [1, 0, 1, 2, 3, 0, 1, 2, 3]]
    enc = [index._encode_pattern(p) for p in pats]
    work = index.stage_encoded(enc)
    staged = work[1]
    assert staged.ready is None and staged.pats.device == index.device
    lo, hi = index.ranges_staged(work)
    lo2, hi2 = index.sa_ranges_batch(pats)
    np.testing.assert_array_equal(lo, lo2)
    np.testing.assert_array_equal(hi, hi2)
    np.testing.assert_array_equal(index._counts_encoded(enc), hi2 - lo2)
    for a, b in zip(index._positions_encoded(enc), index.locate_batch(pats)):
        np.testing.assert_array_equal(a, b)


def test_queue_full_rejects_with_retry_hint(index):
    srv = SAServer(index, max_batch=64, coalesce_max_wait_us=10e6,
                   queue_depth=2, overload_policy="reject").start()
    f1, f2 = srv.submit([0, 1]), srv.submit([1, 0])
    r3 = srv.submit([0, 0]).result(timeout=5.0)
    assert r3.status == "rejected" and not r3.ok
    assert r3.retry_after_us >= 1.0 and r3.count is None
    srv.stop()
    assert f1.result(timeout=5.0).ok and f2.result(timeout=5.0).ok
    c = srv.metrics.counters()
    assert (c["submitted"], c["accepted"], c["rejected"], c["completed"]) \
        == (3, 2, 1, 2)


def test_shed_policy_evicts_the_oldest(index):
    srv = SAServer(index, max_batch=64, coalesce_max_wait_us=10e6,
                   queue_depth=1, overload_policy="shed").start()
    f1 = srv.submit([0, 1])
    f2 = srv.submit([1, 0])
    r1 = f1.result(timeout=5.0)
    assert r1.status == "shed" and r1.total_us >= 0
    srv.stop()
    assert f2.result(timeout=5.0).ok
    assert srv.metrics.counter("shed") == 1


def test_scheduled_arrival_charges_loadgen_lateness(index):
    with SAServer(index, max_batch=4, coalesce_max_wait_us=100.0) as srv:
        r = srv.submit([0, 1], t_arrival=time.perf_counter() - 1.0).result(
            timeout=30.0)
    assert r.ok and r.total_us >= 1e6


def test_submit_validates_synchronously(index):
    srv = SAServer(index)
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit([0])
    srv.start()
    try:
        with pytest.raises(ValueError):
            srv.submit([SIGMA])
        assert srv.submit([]).result(timeout=30.0).count == index.n
    finally:
        srv.stop()


def test_device_failure_lands_in_the_futures(index, monkeypatch):
    def broken(work):
        raise RuntimeError("search failed")

    srv = SAServer(index, max_batch=4, coalesce_max_wait_us=100.0).start()
    monkeypatch.setattr(index, "ranges_staged", broken)
    try:
        fut = srv.submit([0, 1])
        with pytest.raises(RuntimeError, match="search failed"):
            fut.result(timeout=30.0)
    finally:
        srv.stop()


def test_warmup_counts_every_shape(index):
    srv = SAServer(index, max_batch=4)
    assert srv.warmup(pattern_lens=(5, 16)) == 6     # {1,2,4} x {8,16}
    assert srv.warmed_shapes == 6
    assert srv.warmup(pattern_lens=(8,), batch_buckets=(2,)) == 1
    sparse = SuffixArrayIndex.build(np.arange(64) % 5,
                                    SAOptions(sample_rate=16), device=CPU)
    assert SAServer(sparse, max_batch=2).warmup(pattern_lens=(4,)) == 2


def test_metrics_snapshot_absent_not_zero(index):
    snap = SAServer(index).metrics.snapshot()
    assert snap["counters"]["submitted"] == 0
    assert snap["total_us"]["count"] == 0 and snap["total_us"]["p99"] is None
    with SAServer(index, coalesce_max_wait_us=100.0) as srv2:
        srv2.submit([0, 1]).result(timeout=30.0)
    snap = srv2.metrics.snapshot()
    assert snap["total_us"]["p99"] is not None
    assert snap["batch_size"]["count"] == 1
    assert 0 < snap["bucket_occupancy"]["max"] <= 1.0


def test_gc_hygiene_pins_thresholds_and_freezes(index):
    base = gc.get_threshold()
    srv = SAServer(index, max_batch=4)
    with srv:
        assert gc.get_threshold() != base
        assert gc.get_threshold()[:2] == base[:2]
        srv.warmup(pattern_lens=(8,))
        assert srv._gc_frozen and gc.get_freeze_count() > 0
        assert srv.metrics.counter("gc_pauses") == 0
        assert srv.submit([0, 1]).result(timeout=30.0).ok
        gc.collect()
        assert srv.metrics.counter("gc_pauses") == 1
    assert gc.get_threshold() == base
    assert gc.get_freeze_count() == 0
    assert srv._on_gc not in gc.callbacks


def test_gc_hygiene_opt_out(index):
    base = gc.get_threshold()
    with SAServer(index, gc_hygiene=False) as srv:
        assert gc.get_threshold() == base
        srv.warmup(pattern_lens=(8,))
        assert not srv._gc_frozen
        gc.collect()
        assert srv.metrics.counter("gc_pauses") == 0


# ------------------------------------------------------------ QuerySession
def test_query_session_ticks_and_latency_match_jax():
    docs, pats = _corpus(seed=9)
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    ref = japi.SuffixArrayIndex.from_docs(docs, japi.SAOptions(
        backend="seq"))
    sess, jsess = QuerySession(idx, batch_size=4), \
        japi.QuerySession(ref, batch_size=4)
    empty = sess.latency_summary()
    assert empty == {"ticks": 0, "queries": 0, "warmup_ticks": 0,
                     "p50_us": None, "p95_us": None, "p99_us": None,
                     "qps": None}
    assert sess.warmup(pattern_lens=(8, 16)) == 2
    np.testing.assert_array_equal(sess.count(pats), jsess.count(pats))
    np.testing.assert_array_equal(sess.contains(pats), jsess.contains(pats))
    for a, b in zip(sess.locate(pats), jsess.locate(pats)):
        np.testing.assert_array_equal(a, b)
    s = sess.latency_summary()
    ticks = 3 * -(-len(pats) // 4)
    assert (s["ticks"], s["queries"], s["warmup_ticks"]) == \
        (ticks, 3 * len(pats), 2)
    assert 0 < s["p50_us"] <= s["p95_us"] <= s["p99_us"] and s["qps"] > 0
    assert sess.count([]).shape == (0,)
    sess.reset_latency()
    assert sess.latency_summary()["ticks"] == 0
    with pytest.raises(ValueError):
        QuerySession(idx, batch_size=0)


def test_query_session_submit_starts_a_server():
    docs, pats = _corpus(seed=10)
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    with QuerySession(idx, batch_size=4) as sess:
        assert sess.server is None
        first = sess.submit(pats[0], coalesce_max_wait_us=100.0)
        assert sess.server is not None and sess.server.coalescer.max_batch \
            == 4
        with pytest.raises(ValueError, match="first submit"):
            sess.submit(pats[1], queue_depth=3)
        rest = [sess.submit(p) for p in pats[1:]]
        got = [f.result(timeout=30.0).count for f in [first] + rest]
    assert sess.server is None
    assert got == idx.count_batch(pats).tolist()


def test_query_cache_stats_count_shapes():
    docs, pats = _corpus(seed=11)
    idx = SuffixArrayIndex.from_docs(docs, device=CPU)
    clear_query_cache()
    assert query_cache_stats() == {"buckets": 0, "hits": 0, "misses": 0}
    idx.count_batch(pats[:3])
    idx.count_batch(pats[:3])
    idx.count_batch(pats)
    assert query_cache_stats() == {"buckets": 2, "hits": 1, "misses": 2}
    # a shape is the search's windows, whatever the index's size
    SuffixArrayIndex.from_docs(docs[:3], device=CPU).count_batch(pats[:3])
    assert query_cache_stats() == {"buckets": 2, "hits": 2, "misses": 2}
    # the sparse search counts its own shapes
    sparse = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=4),
                                        device=CPU)
    sparse.count_batch(pats[:3])
    sparse.count_batch(pats[:3])
    assert query_cache_stats() == {"buckets": 3, "hits": 3, "misses": 3}
    # hits from several threads are all counted
    threads = [threading.Thread(target=lambda: [
        idx.count_batch(pats[:3]) for _ in range(5)]) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert query_cache_stats() == {"buckets": 3, "hits": 23, "misses": 3}
    clear_query_cache()
    assert query_cache_stats()["buckets"] == 0


def test_stage_batch_stays_off_the_card_on_a_cpu_index(index):
    qb = QueryBatch.encode(index, [[0, 1], [2]])
    staged = stage_batch(index, qb)
    assert staged.ready is None
    assert staged.pats.device.type == "cpu" and staged.pats.shape == (2, 8)
    assert staged.lens.tolist() == [2, 1]


# ------------------------------------------------- configs and the launch
def test_sa_config_matches_jax():
    ours, theirs = get_config("suffix-array"), jget_config("suffix-array")
    assert isinstance(ours, SAConfig)
    fields = {f.name for f in dataclasses.fields(ours)}
    assert fields <= {f.name for f in dataclasses.fields(theirs)}
    assert all(getattr(ours, k) == getattr(theirs, k) for k in fields)
    assert get_config("suffix_array") is ours
    assert ours.to_options().fingerprint() == \
        theirs.to_options().fingerprint()
    assert ours.to_options().resolve_backend() == "torch"


def test_model_archs_are_not_ported_yet():
    """Every model architecture resolves now (item 2b is done), equal to
    the reference's; an unknown one raises."""
    assert len(model_archs()) == 10
    for arch in ("rwkv6-1.6b", "phi3.5-moe-42b-a6.6b", "gemma3_1b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    with pytest.raises(ValueError, match="unknown --arch"):
        get_config("nope")


def test_serve_sa_queries_matches_jax(capsys):
    """The launch's corpus, index and served counts equal the JAX
    package's `serve_sa_queries` for the same seed."""
    jcfg = dataclasses.replace(jget_config("suffix-array"), backend="seq")
    ref = jserve_sa_queries(jcfg, n_chars=20_000, n_docs=4, n_queries=24,
                            query_batch=8, seed=3)
    run = launch_serve.serve_sa_queries(
        get_config("suffix-array"), n_chars=20_000, n_docs=4, n_queries=24,
        query_batch=8, seed=3, device=CPU)
    assert run.index.device == torch.device(CPU)
    np.testing.assert_array_equal(run.index.sa.numpy(), ref.sa)
    np.testing.assert_array_equal(run.index.text.numpy(), ref.text)
    want = ref.count_batch(run.patterns)
    assert run.planted.tolist() == [q % 2 == 0 for q in range(24)]
    assert (want[run.planted] >= 1).all()
    assert len(run.responses) == run.summary["offered"] > 0
    for q, r in enumerate(run.responses):
        assert r.status in ("ok", "rejected", "shed")
        if r.ok:
            assert r.count == want[q % 24]
    assert run.store_status == "off" and run.warmup_shapes == 4
    assert "backend=torch, device=cpu" in capsys.readouterr().out


def test_launch_main_segmented_ingest(tmp_path, capsys):
    argv = ["--arch", "suffix-array", "--smoke", "--device", "cpu",
            "--batch", "8", "--queries", "32", "--segments", "4",
            "--ingest", "3", "--store", str(tmp_path)]
    run = launch_serve.main(argv)
    assert isinstance(run.index, SegmentedIndex)
    assert run.store_status == "miss" and run.index.n_docs == 11
    ing = run.ingest
    assert ing["docs"] == 3 and ing["builds"] == 3 + ing["merges"]
    assert ing["segments_written"] >= 1
    mono = SuffixArrayIndex.from_docs(
        [run.index.doc(i) for i in run.index.doc_ids], device=CPU)
    np.testing.assert_array_equal(run.index.count_batch(run.patterns),
                                  mono.count_batch(run.patterns))
    assert "segment store: miss" in capsys.readouterr().out
    again = launch_serve.main(argv[:-6] + ["--segments", "4", "--store",
                                           str(tmp_path)])
    assert again.store_status == "hit"
    with pytest.raises(ValueError, match="--ingest requires"):
        launch_serve.main(argv[:9] + ["--ingest", "1"])


def test_import_serving_modules_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.ckpt, repro_torch.configs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_launch_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "suffix-array", "--smoke"])
    for make in (lambda: serve.SAServer(SegmentedIndex()),
                 lambda: QuerySession(SegmentedIndex())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_response_is_the_jax_packages_shape():
    assert [f.name for f in dataclasses.fields(Response)] == \
        [f.name for f in dataclasses.fields(jserve.Response)]
    assert Response(req_id=0, status="ok").ok
    assert not Response(req_id=0, status="shed").ok
