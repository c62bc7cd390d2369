"""The port's CUDA kernels held against their plain PyTorch versions on the
card, element for element (tolerance 0), and a small build through them.

Marked `gpu`: without a CUDA device every test here skips (the fixture
decides, at run time). On a machine with one card run
``python -m pytest -m gpu tests/test_torch_gpu.py``. This file imports no
JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import SAOptions, SuffixArrayIndex
from repro_torch.core.dcv_torch import _order_from_words, suffix_array_torch
from repro_torch.kernels import bitonic_sort as bsort
from repro_torch.kernels import ops, ref
from repro_torch.sparse import build_sparse_suffix_array
from torch_pass_keys import PASS_KINDS, pass_keys

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rows(rng, n, w, hi=5):
    return torch.from_numpy(rng.integers(-hi, hi, (n, w)).astype(np.int32))


@pytest.mark.parametrize("w", [2, 4, 9, 66])
@pytest.mark.parametrize("kj", [(2, 1), (64, 8), (512, 128), (4096, 1024),
                                (8192, 4096)])
def test_bitonic_stage_kernel_matches_plain(cuda, w, kj):
    rows = _rows(np.random.default_rng(w), 8192, w).to(cuda)
    k, j = kj
    for num_keys in (w, max(1, w // 2)):
        got = ops.bitonic_stage(rows, k, j, num_keys)
        torch.testing.assert_close(got, ref.bitonic_stage_ref(rows, k, j,
                                                              num_keys),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n", [2 ** 10, 2 ** 16, 2 ** 20])
def test_bitonic_sort_kernel_matches_plain(cuda, n):
    rows = _rows(np.random.default_rng(n), n, 4, hi=50).to(cuda)
    rows[:, 3] = torch.randperm(n, generator=torch.Generator().manual_seed(n)
                                ).to(cuda, torch.int32)
    before = dict(ops.LAUNCHES)
    got = ops.bitonic_sort(rows)
    launches = bsort.schedule(n, 4)
    for kind in ("tile", "cross"):
        name = f"bitonic_{kind}"
        assert ops.LAUNCHES[name] - before[name] == sum(
            launch.kind == kind for launch in launches)
    assert ops.LAUNCHES["bitonic_stage"] == before["bitonic_stage"]
    torch.testing.assert_close(got, ref.bitonic_sort_ref(rows), rtol=0,
                               atol=0)


def _launch_cases():
    # N below, at and above the tile T, then 2^20 rows
    for w in (3, 9, 66, 187):
        t = bsort.tile_rows(2 ** 30, w)
        for n in (t // 2, t, 4 * t):
            yield n, w
    yield 2 ** 20, 4


@pytest.mark.parametrize("n,w", list(_launch_cases()))
@pytest.mark.parametrize("keys", ["all", "prefix"])
def test_bitonic_launches_match_plain(cuda, n, w, keys):
    # every launch of the schedule (tile sort, cross-tile runs, in-tile
    # merges) against its stages applied one by one on the plain version;
    # "prefix" ties keys with differing trailing columns (the copy rule)
    rng = np.random.default_rng(n + w)
    rows = _rows(rng, n, w, hi=2 if keys == "prefix" else 50).to(cuda)
    num_keys = w if keys == "all" else max(1, w // 3)
    launches = bsort.schedule(n, w)
    kinds = {launch.kind for launch in launches}
    assert kinds == ({"tile", "cross"} if n > bsort.tile_rows(n, w)
                     else {"tile"})
    cur = rows
    for launch in launches:
        want = ref.bitonic_stages_ref(cur, launch.stages(), num_keys)
        got = bsort.bitonic_launch_cuda(cur.clone(), launch, num_keys)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        cur = want
    whole = ops.bitonic_sort(rows, num_keys)
    torch.testing.assert_close(whole, cur, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_distinct"])
@pytest.mark.parametrize("block", [32, 512, 1024])
def test_seg_boundary_kernel_matches_plain(cuda, kind, block):
    n = 4096
    if kind == "random":
        rows = ref.bitonic_sort_ref(_rows(np.random.default_rng(1), n, 3,
                                          hi=2))
    elif kind == "all_equal":
        rows = torch.full((n, 3), 7, dtype=torch.int32)
    else:
        rows = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, 2)
    rows = rows.to(cuda)
    for num_keys in (None, 1):
        for g, w in zip(ops.seg_boundary(rows, num_keys, block),
                        ref.seg_boundary_ref(rows, num_keys, block)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 511, 1300, 70_001])
def test_dense_rank_kernel_matches_plain(cuda, n):
    rows = ref.bitonic_sort_ref(_rows(np.random.default_rng(n), n, 3, hi=3))
    got, nd = ops.dense_rank_sorted(rows.to(cuda), 2)
    want, want_nd = ops.dense_rank_sorted(rows, 2)         # plain, on CPU
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert int(nd) == int(want_nd)


def test_small_build_goes_through_the_kernels(cuda):
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 4, 3000) for _ in range(4)]
    docs.append(docs[0][100:900])
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    idx = SuffixArrayIndex.from_docs(docs, device=cuda)
    # "auto" on the card is the radix path: its two kernels launched, the
    # bitonic ones and seg_boundary did not
    assert {k for k, v in ops.LAUNCHES.items() if v} == {
        "radix_hist", "radix_scatter"}
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    kernel = SuffixArrayIndex.from_docs(docs, SAOptions(sort_impl="kernel"),
                                        device=cuda)
    # the explicit "kernel" path: the shared-memory sort's two kernels and
    # seg_boundary launched, the one-stage kernel and the radix ones did not
    assert {k for k, v in ops.LAUNCHES.items() if v} == {
        "bitonic_tile", "bitonic_cross", "seg_boundary"}
    cpu = SuffixArrayIndex.from_docs(docs, device="cpu")
    torch.testing.assert_close(idx.sa.cpu(), cpu.sa, rtol=0, atol=0)
    torch.testing.assert_close(kernel.sa.cpu(), cpu.sa, rtol=0, atol=0)
    x = np.asarray(idx.text.cpu())
    torch.testing.assert_close(
        suffix_array_torch(x, sort_impl="torch", device=cuda).cpu(), cpu.sa,
        rtol=0, atol=0)
    pats = [d[50:80] for d in docs] + [np.zeros(0, np.int64)]
    np.testing.assert_array_equal(idx.count_batch(pats),
                                  cpu.count_batch(pats))
    for a, b in zip(idx.locate_batch(pats[:-1]), cpu.locate_batch(pats[:-1])):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- radix sort
@pytest.mark.parametrize("n,bins,block", [
    (1024, 256, 256), (2048, 8, 1024), (512, 2, 128), (4096, 128, 512),
    (256, 16, 256), (128, 1, 64), (2 ** 20, 257, 1024), (999, 8, 128),
    (2 ** 20 + 5, 257, 4096)])
def test_radix_hist_kernel_matches_plain(cuda, n, bins, block):
    rng = np.random.default_rng(n + bins)
    d = torch.from_numpy(rng.integers(0, bins, n).astype(np.int32))
    for digits in (d, torch.full_like(d, bins - 1), torch.zeros_like(d)):
        got = ops.radix_histogram_blocks(digits.to(cuda), bins, block)
        want = ops.radix_histogram_blocks(digits, bins, block)   # plain, CPU
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    if n % block == 0:
        got = ops.radix_histogram_blocks(d.to(cuda), bins, block)
        torch.testing.assert_close(
            got, ref.radix_histogram_ref(d.to(cuda), bins, block), rtol=0,
            atol=0)


def _pass_keys(kind, n):
    return torch.from_numpy(
        pass_keys(kind, n, np.random.default_rng([n, len(kind)])))


@pytest.mark.parametrize("kind", PASS_KINDS)
@pytest.mark.parametrize("n", [1, 2, 999, 4096, 4097, 70_001, 2 ** 20 + 5,
                               2 ** 24])
@pytest.mark.parametrize("block", [1024, 4096])
def test_radix_pass_counts_kernel_matches_plain(cuda, kind, n, block):
    # the key loader against the plain version: the zero-led bin-major
    # counts, equal element for element
    keys = _pass_keys(kind, n)
    on_card = keys.to(cuda)
    for shift in (0, 8, 16, 40, 56):
        want = ref.radix_pass_counts_ref(keys, shift, block)
        before = ops.LAUNCHES["radix_hist"]
        got = ops.radix_pass_counts(on_card, shift, block)
        assert ops.LAUNCHES["radix_hist"] == before + 1
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_radix_pass_counts_kernel_reads_unaligned_keys(cuda):
    # a view that starts 8 bytes into its storage takes the one-element path
    keys = _pass_keys("random", 10_001).to(cuda)
    for block in (1024, 4096):
        torch.testing.assert_close(
            ops.radix_pass_counts(keys[1:], 16, block),
            ref.radix_pass_counts_ref(keys[1:], 16, block), rtol=0, atol=0)
    # no keys: the leading zero alone, and no launch counted
    before = ops.LAUNCHES["radix_hist"]
    empty = ops.radix_pass_counts(keys[:0], 0, 4096)
    assert empty.tolist() == [0]
    assert ops.LAUNCHES["radix_hist"] == before


@pytest.mark.parametrize("kind", ["random", "constant", "distinct",
                                  "skewed"])
@pytest.mark.parametrize("n,block", [(1000, 256), (70_001, 1024),
                                     (4096, 2048), (3 * 4096, 4096),
                                     (70_001, 4096), (2 ** 20, 4096)])
@pytest.mark.parametrize("payload_dtype", [torch.int32, torch.int64])
def test_radix_scatter_kernel_matches_plain(cuda, kind, n, block,
                                            payload_dtype):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy({
        "random": rng.integers(0, 2 ** 40, n),
        "constant": np.full(n, 3 << 24),
        "distinct": rng.permutation(n) << 24,
        # nine digits in ten are 0, the rest spread over all 256
        "skewed": np.where(rng.random(n) < 0.9, 0,
                           rng.integers(0, 256, n)) << 24}[kind]
        .astype(np.int64))
    shift = 24
    nb = -(-n // block)
    offsets = torch.cumsum(ref.radix_pass_counts_ref(keys, shift, block), 0,
                           dtype=torch.int32)[:-1].view(256, nb)
    payload = torch.arange(n, dtype=payload_dtype)
    want = ref.radix_scatter_ref(keys, payload, shift, offsets, block)
    got = ops.radix_scatter(keys.to(cuda), payload.to(cuda), shift,
                            offsets.to(cuda), block)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    none, p_only = ops.radix_scatter(keys.to(cuda), payload.to(cuda), shift,
                                     offsets.to(cuda), block,
                                     write_keys=False)
    assert none is None
    torch.testing.assert_close(p_only.cpu(), want[1], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 1024, 1025, 300_000])
@pytest.mark.parametrize("kind", ["one_word", "three_words", "62bit"])
def test_radix_argsort_kernels_match_stable_sort_passes(cuda, n, kind):
    rng = np.random.default_rng(n + len(kind))
    if kind == "one_word":
        bits, words = 45, [rng.integers(0, 2 ** 45, n)]
    elif kind == "three_words":
        bits, words = [20, 9, 2], [rng.integers(0, 50, n),
                                   rng.integers(0, 512, n),
                                   rng.integers(0, 4, n)]
    else:
        bits, words = 62, [rng.integers(0, 2 ** 62, n)]
    words = [torch.from_numpy(np.asarray(w, np.int64)).to(cuda)
             for w in words]
    before = ops.LAUNCHES["radix_scatter"]
    got = ops.radix_argsort(words, bits)
    if n > 1:
        assert ops.LAUNCHES["radix_scatter"] > before
    torch.testing.assert_close(got, _order_from_words(words), rtol=0, atol=0)
    torch.testing.assert_close(got, ref.radix_argsort_ref(words, bits),
                               rtol=0, atol=0)


def test_small_radix_and_sparse_builds_match_cpu(cuda):
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 6, 2500) for _ in range(4)]
    docs.append(docs[1][200:1200])
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    radix = SuffixArrayIndex.from_docs(docs, SAOptions(sort_impl="radix"),
                                       device=cuda)
    assert {k for k, v in ops.LAUNCHES.items() if v} == {"radix_hist",
                                                          "radix_scatter"}
    cpu = SuffixArrayIndex.from_docs(docs, SAOptions(sort_impl="radix"),
                                     device="cpu")
    torch.testing.assert_close(radix.sa.cpu(), cpu.sa, rtol=0, atol=0)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    sparse = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=8),
                                        device=cuda)
    assert ops.LAUNCHES["radix_hist"] > 0 and ops.LAUNCHES["radix_scatter"] > 0
    sparse_cpu = build_sparse_suffix_array(cpu.text, 8, device="cpu")
    torch.testing.assert_close(sparse.sa.cpu(), sparse_cpu, rtol=0, atol=0)
    dense = cpu.sa.long()
    torch.testing.assert_close(sparse_cpu.long(), dense[dense % 8 == 0],
                               rtol=0, atol=0)
    pats = [d[50:80] for d in docs]
    np.testing.assert_array_equal(sparse.count_batch(pats),
                                  cpu.count_batch(pats))
    for a, b in zip(sparse.locate_batch(pats), cpu.locate_batch(pats)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["radix", "torch", "bitonic"])
def test_bsp_build_on_the_card_matches_the_single_device_sa(cuda, impl):
    from repro_torch.bsp.counters import BSPCounters
    from repro_torch.bsp.suffix_array import suffix_array_bsp
    from repro_torch.launch.mesh import make_sa_mesh
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.integers(0, 20, 60_000)).to(cuda)
    x[30_000:31_000] = x[1_000:2_000]             # Lemma-1 ties at depth
    want = suffix_array_torch(x, device=cuda)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    mesh = make_sa_mesh(8, device="cuda")
    ct = BSPCounters()
    got = suffix_array_bsp(x, mesh, base_threshold=2048, counters=ct,
                           sort_impl=impl)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ct.rounds >= 2 and mesh.rendezvous == ct.supersteps - sum(
        e["label"] == "base/gather" for e in ct.log)
    # "torch" sorts its keys with torch.sort; its base case is the default
    # single-device build, on the radix kernels
    launched = {k for k, v in ops.LAUNCHES.items() if v}
    if impl == "torch":
        assert launched <= {"radix_hist", "radix_scatter"}, ops.LAUNCHES
    else:
        assert launched == {"radix_hist", "radix_scatter"}, ops.LAUNCHES


# ------------------------------------------------------- serving on the card
def _serving_corpus():
    rng = np.random.default_rng(15)
    docs = [rng.integers(0, 8, int(rng.integers(500, 3000)))
            for _ in range(6)]
    pats = [d[a:a + m] for d in docs for a, m in ((7, 16), (100, 40))]
    pats += [rng.integers(0, 8, m) for m in (16, 20, 64, 200)]
    return docs, pats


@pytest.mark.parametrize("rate", [1, 8])
def test_side_stream_staging_matches_unstaged(cuda, rate):
    from repro_torch.api import QueryBatch, batch_ranges, stage_batch
    docs, pats = _serving_corpus()
    idx = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=rate),
                                     device=cuda)
    cpu = SuffixArrayIndex.from_docs(docs, device="cpu")
    want = cpu.count_batch(pats)
    # stage several batches ahead of the searches, as the server's
    # coalesce thread does, then resolve them in order
    chunks = [pats[i:i + 5] for i in range(0, len(pats), 5)]
    works = [idx.stage_encoded([idx._encode_pattern(p) for p in c])
             for c in chunks]
    for _, staged in works:
        assert isinstance(staged.ready, torch.cuda.Event)
        assert staged.pats.device.type == "cuda"
    got = np.concatenate([np.subtract(*idx.ranges_staged(w)[::-1])
                          for w in works])
    np.testing.assert_array_equal(got, want)
    if rate == 1:
        qb = QueryBatch.encode(idx, pats)
        for a, b, c in zip(batch_ranges(idx, qb, staged=stage_batch(idx, qb)),
                           batch_ranges(idx, qb), cpu.sa_ranges_batch(pats)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("kind", ["dense", "sparse", "segmented"])
def test_sa_server_on_the_card_equals_count_batch(cuda, kind):
    from repro_torch.api import SegmentedIndex
    from repro_torch.serve import SAServer
    docs, pats = _serving_corpus()
    if kind == "segmented":
        idx = SegmentedIndex.from_docs(docs, segment_docs=2, device=cuda)
    else:
        idx = SuffixArrayIndex.from_docs(
            docs, SAOptions(sample_rate=8 if kind == "sparse" else 1),
            device=cuda)
    want = SuffixArrayIndex.from_docs(docs, device="cpu").count_batch(
        pats * 4)
    with SAServer(idx, max_batch=8, coalesce_max_wait_us=300.0) as srv:
        srv.warmup(pattern_lens=(16, 64, 256))
        futs = [srv.submit(p) for p in pats * 4]
        got = [f.result(timeout=120.0) for f in futs]
    assert all(r.ok for r in got)
    np.testing.assert_array_equal([r.count for r in got], want)
    np.testing.assert_array_equal(idx.count_batch(pats * 4), want)


def test_store_round_trip_to_and_from_the_card(cuda, tmp_path):
    from repro_torch.api import IndexStore
    docs, pats = _serving_corpus()
    built = SuffixArrayIndex.from_docs(docs, device=cuda)
    _ = built.lcp
    store = IndexStore(str(tmp_path), device=cuda)
    store.save("card", built)
    got = store.load("card", options=SAOptions())
    assert got.sa.device.type == "cuda" and got.text.device.type == "cuda"
    assert torch.equal(got.sa, built.sa) and torch.equal(got.text,
                                                         built.text)
    np.testing.assert_array_equal(got.lcp, built.lcp)
    on_cpu = IndexStore(str(tmp_path), device="cpu").load("card")
    assert torch.equal(on_cpu.sa, built.sa.cpu())
    IndexStore(str(tmp_path), device="cpu").save("host", on_cpu)
    back = store.load("host")
    assert back.sa.device.type == "cuda" and torch.equal(back.sa, built.sa)
    np.testing.assert_array_equal(back.count_batch(pats),
                                  on_cpu.count_batch(pats))
    sparse = SuffixArrayIndex.from_docs(docs, SAOptions(sample_rate=8),
                                        device=cuda)
    store.save("sparse", sparse)
    again = store.load("sparse", options=SAOptions(sample_rate=8))
    assert torch.equal(again.sa, sparse.sa)
    np.testing.assert_array_equal(again.count_batch(pats),
                                  on_cpu.count_batch(pats))


# ------------------------------------------------- the data plane on the card
def test_data_plane_on_the_card_equals_the_cpu_port(cuda):
    from repro_torch.data.pipeline import (PipelineConfig, TrainingDataPlane,
                                           synthetic_doc_shards)
    shards = synthetic_doc_shards(12_000, 64, shard_docs=4, doc_len=1000,
                                  dup_fraction=0.4, seed=3)
    assert len(shards) == 3
    rng = np.random.default_rng(11)
    eval_docs = [rng.integers(0, 64, 1500) for _ in range(2)]
    eval_docs[1][:300] = shards[1][0][:300]
    cfg = PipelineConfig(seq_len=96, global_batch=4, dedup=True,
                         dedup_min_len=24, gate_min_len=24, vocab=64)
    card = TrainingDataPlane(cfg, eval_docs=eval_docs, device=cuda)
    for shard in shards:
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        st = card.ingest_shard(shard)
        assert st.builds == 1
        # each segment build ran the radix path, "auto" on the card
        assert {k for k, v in ops.LAUNCHES.items() if v} == {
            "radix_hist", "radix_scatter"}
    assert card.index.device.type == "cuda"
    assert card.gate.index.sa.device.type == "cuda"
    cpu = TrainingDataPlane(cfg, eval_docs=eval_docs, shards=shards,
                            device="cpu")
    assert card.report.dropped_chars == cpu.report.dropped_chars > 0
    assert len(card._kept) == len(cpu._kept)
    for a, b in zip(card._kept, cpu._kept):
        np.testing.assert_array_equal(a, b)
    for step in range(4):
        got, want = card.batch_at(step), cpu.batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert card.gate_stats() == cpu.gate_stats()
    samples = [shards[2][1][10:300], rng.integers(0, 64, 200)]
    assert card.probe(samples) == cpu.probe(samples)


# ------------------------------------------------------------------ the LM
def _lm_pair(cuda, arch="gemma3_1b"):
    """gemma3-1b at smoke: the same params (one CPU generator) on the CPU
    and on the card."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).smoke()
    host = lm.lm_init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    return cfg, host, copy.deepcopy(host).to(cuda)


def test_lm_on_the_card_matches_the_cpu_path(cuda):
    """Logits within 0.05 of the largest (the bf16 rule of the CPU
    tests), the loss within 1e-2, one train step's loss and grad norm
    within 1e-2 and 5%; the train step launches no hand kernel."""
    from repro_torch.models import lm
    from repro_torch.models.layers import logits_from_embedding
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step)
    cfg, host, card = _lm_pair(cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)))
    mask = torch.from_numpy((rng.random((2, 40)) > 0.3).astype(np.float32))
    with torch.no_grad():
        out = {}
        for name, model, dev in (("cpu", host, "cpu"), ("card", card, cuda)):
            h, _, _ = lm.forward_hidden(model, cfg, toks[:, :-1].to(dev))
            logits = logits_from_embedding(h, model.embed, cfg.logit_softcap)
            loss, _ = lm.lm_loss(model, cfg, {"tokens": toks.to(dev),
                                              "loss_mask": mask.to(dev)})
            out[name] = (logits.cpu(), float(loss))
    want, got = out["cpu"], out["card"]
    assert float((got[0] - want[0]).abs().max() / want[0].abs().max()) < 0.05
    assert abs(got[1] - want[1]) < 1e-2
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), warmup=0, total_steps=4)
    batch = {"tokens": toks.numpy(), "loss_mask": mask.numpy()}
    metrics = {}
    for name, model in (("cpu", host), ("card", card)):
        before = dict(ops.LAUNCHES)
        _, metrics[name] = make_train_step(cfg, tcfg)(
            make_train_state(model, tcfg), batch)
        assert ops.LAUNCHES == before
    assert abs(float(metrics["card"]["loss"])
               - float(metrics["cpu"]["loss"])) < 1e-2
    assert abs(float(metrics["card"]["grad_norm"])
               / float(metrics["cpu"]["grad_norm"]) - 1) < 0.05
    assert next(card.parameters()).device.type == "cuda"


def test_lm_decode_matches_forward_past_the_window_on_the_card(cuda):
    from repro_torch.launch.serve import prefill_then_decode
    from repro_torch.models import lm
    from repro_torch.models.layers import logits_from_embedding
    cfg, _, card = _lm_pair(cuda)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 12))
    toks = prefill_then_decode(card, cfg, prompts, 14)
    T = toks.shape[1]
    assert toks.device.type == "cuda" and T > cfg.window
    with torch.no_grad():
        h, _, _ = lm.forward_hidden(card, cfg, toks)
        full = logits_from_embedding(h, card.embed, cfg.logit_softcap)
        scale = float(full.abs().max())
        states = lm.init_decode_states(cfg, 3, cache_len=T, device=cuda)
        for t in range(T):
            lg, states = lm.decode_step(card, cfg, toks[:, t:t + 1], states,
                                        t)
            assert float((lg[:, 0] - full[:, t]).abs().max()) / scale < 0.05


def _module_pair(cuda, Mod, cfg, seed=0):
    """One parameter module of `Mod` drawn on the CPU, and its copy on
    the card."""
    import copy
    from repro_torch.models.lm import reset_parameters
    host = Mod(cfg, device="cpu")
    reset_parameters(host, torch.Generator().manual_seed(seed))
    return host, copy.deepcopy(host).to(cuda)


def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """phi3.5-moe's MoE at smoke widths: from the same router logits the
    card routes exactly as the CPU (ids, slots, keep flags); the layer's
    output within 0.05 of the largest, its aux loss within 1e-5 relative
    and its gradients within 0.05; no hand kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    cfg = get_config("phi35_moe_42b_a6_6b").smoke()
    host, card = _module_pair(cuda, ffn.MoE, cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).to(torch.bfloat16)
    logits = torch.randn(80, cfg.n_experts,
                         generator=torch.Generator().manual_seed(2))
    want, got = ffn.moe_route(logits, cfg), ffn.moe_route(logits.to(cuda),
                                                          cfg)
    for key in ("ids", "slot", "keep", "eid", "eslot", "ekeep"):
        torch.testing.assert_close(getattr(got, key).cpu(),
                                   getattr(want, key), rtol=0, atol=0)
    before = dict(ops.LAUNCHES)
    res = {}
    for name, mod, dev in (("cpu", host, "cpu"), ("card", card, cuda)):
        out, aux = ffn.moe_layer(mod, cfg, x.to(dev))
        (torch.sum(torch.square(out.float())) + aux).backward()
        res[name] = (out.detach().float().cpu(), float(aux.detach()),
                     {n: p.grad.cpu() for n, p in mod.named_parameters()})
    assert ops.LAUNCHES == before
    (o_w, a_w, g_w), (o_g, a_g, g_g) = res["cpu"], res["card"]
    assert float((o_g - o_w).abs().max() / o_w.abs().max()) < 0.05
    assert abs(a_g / a_w - 1) < 1e-5
    for n, g in g_w.items():
        assert float((g_g[n] - g).abs().max() / g.abs().max()) < 0.05, n


def test_rwkv6_step_on_the_card_matches_the_cpu(cuda):
    """rwkv6-1.6b's time-mix and channel-mix at smoke widths: a 16-token
    chunk, then one decode step from the carried state, on the card
    against the CPU: outputs within 0.05 of the largest, the states
    within 1e-2 (float32 fed by bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    cfg = get_config("rwkv6_1_6b").smoke()
    g = torch.Generator().manual_seed(3)
    x = (0.5 * torch.randn(2, 17, cfg.d_model, generator=g)).to(
        torch.bfloat16)
    for Mod, fn, seed in ((rwkv6.TimeMix, rwkv6.rwkv_time_mix, 4),
                          (rwkv6.ChannelMix, rwkv6.rwkv_channel_mix, 5)):
        host, card = _module_pair(cuda, Mod, cfg, seed)
        with torch.no_grad():
            for p in (*host.parameters(), *card.parameters()):
                if not p.any():             # the zero-init mixes and bases
                    p.fill_(0.3)
        res = {}
        with torch.no_grad():
            for name, mod, dev in (("cpu", host, "cpu"), ("card", card, cuda)):
                first, st = fn(mod, cfg, x[:, :16].to(dev))
                step, st = fn(mod, cfg, x[:, 16:].to(dev), state=st)
                res[name] = [first.float().cpu(), step.float().cpu(),
                             *(v.float().cpu() for v in st.values())]
        for i, (w, c) in enumerate(zip(res["cpu"], res["card"])):
            tol = 0.05 if i < 2 else 1e-2
            assert float((c - w).abs().max() / w.abs().max()) < tol, \
                (Mod.__name__, i)


@pytest.mark.parametrize("arch", ["gemma3-1b", "phi3.5-moe-42b-a6.6b"])
def test_dry_run_count_and_bytes_equal_the_card_step(cuda, arch):
    """The dry run's trip-count-scaled FLOP count on ``meta`` equals the
    same counter over one real train step on the card, and its one-card
    argument bytes the bytes of the state there (``smoke()`` widths, three
    periods and a layer more, so that the count scales)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, op_stats
    from repro_torch.models.config import ShapeConfig
    cfg = get_config(arch).smoke()
    cfg = cfg.replace(n_layers=3 * len(cfg.pattern) + 1)
    tcfg = dryrun.default_train_config(cfg)
    meta = op_stats.scaled_count(
        lambda c, S: dryrun.train_step_args(c, tcfg, 2, S), cfg, 64)
    assert meta["scaled"]["periods"] == cfg.n_layers // len(cfg.pattern)
    _, _, specs = dryrun.step_cell(cfg, ShapeConfig("t", 64, 2, "train"),
                                   {"data": 1, "model": 1})
    step, (state, data) = dryrun.train_step_args(cfg, tcfg, 2, 64,
                                                 device=cuda)
    assert dryrun.state_nbytes(state) == {
        k: dryrun.tree_nbytes(specs[k]) for k in ("params", "opt")}
    assert op_stats.count(step, state, data)["flops"] == meta["flops"]
