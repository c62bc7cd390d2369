"""Serve substring queries over a suffix-array index through the
asynchronous serving tier, or decode from a language model, on the card.

    python -m repro_torch.launch.serve --arch suffix-array --smoke \\
        --queries 64 --store build/sa_store --query-batch 64 \\
        --offered-qps 2000

The port of `repro.launch.serve`. Its suffix-array half obtains a
`repro_torch.api.SuffixArrayIndex` over a seeded synthetic corpus —
restored from a persistent `repro_torch.api.IndexStore` when `--store`
points at a warm one, built through the facade otherwise (the port's
``"auto"`` backend: the torch DC-v build on `--device`) — and serves
substring count queries through `repro_torch.serve.SAServer`: open-loop
seeded arrivals (`--arrival poisson|onoff|uniform` at `--offered-qps`),
coalescing into pow2 buckets, admission control (`--overload-policy`)
and per-request queue/service/total latency percentiles, with a warmup
pass excluded. `--segments K` serves a `SegmentedIndex` of K segments
(persisted through a `SegmentedIndexStore`) and `--ingest M` streams M
documents through `add_docs` after the build. When more than one device
of `--device`'s kind is visible, the index is built by Algorithm 3 on a
mesh of one rank a device (the bsp backend, `repro_torch.launch.mesh`)
and the run prints its BSP costs, as the JAX package does on a
multi-device host; on one card the torch backend builds it.

The LM half (``--arch <model>``, any of the ten model architectures):
`prefill_then_decode` of a seeded prompt batch through a freshly
initialised model, greedy (or sampled with ``--temperature > 0`` from a
seeded `torch.Generator`); for an encoder-decoder config the decoder
attends to the encoding of seeded frame embeddings.

    python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 \\
        --prompt-len 16 --gen 32
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.compat import resolve_device
from ..models.lm import decode_step, encode, init_decode_states, lm_init
from ..trace import counters


@torch.no_grad()
def prefill_then_decode(params, cfg, prompts, gen: int, *, enc_out=None,
                        temperature: float = 0.0, seed: int = 0):
    """prompts integer [B, P] (numpy or tensor) → tokens int32 [B, P+gen] on
    the model's device. `params` is an `repro_torch.models.lm.LM`. Prefill
    runs stepwise through the decode path (correct for ring buffers), as
    in the JAX package. Greedy at ``temperature=0``; otherwise sampled
    from a `torch.Generator` seeded with `seed` (not the JAX package's
    random stream). `enc_out` is an encoder-decoder's `encode` output,
    which every step's cross-attention reads."""
    dev = params.device
    prompts = torch.as_tensor(np.asarray(prompts) if not torch.is_tensor(
        prompts) else prompts).to(dev, torch.int32)
    B, P = prompts.shape
    states = init_decode_states(cfg, B, cache_len=P + gen, device=dev)
    gen_rng = torch.Generator(device=dev).manual_seed(seed)
    out = [prompts[:, i:i + 1] for i in range(P)]
    logits = None
    for t in range(P):
        logits, states = decode_step(params, cfg, out[t], states, t,
                                     enc_out=enc_out)
    for g in range(gen):
        if temperature > 0:
            probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen_rng)
        else:
            nxt = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out.append(nxt.to(torch.int32))
        logits, states = decode_step(params, cfg, out[-1], states, P + g,
                                     enc_out=enc_out)
    return torch.cat(out, dim=1)


def serve_lm(cfg, *, batch: int, prompt_len: int, gen: int,
             temperature: float = 0.0, device="cuda"):
    """The LM branch of `main`: seeded prompts through a seeded model.
    Returns the tokens [batch, prompt_len + gen]."""
    dev = resolve_device(device)
    params = lm_init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    enc_out = None
    if cfg.is_encdec:
        enc = 0.02 * rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        with torch.no_grad():
            enc_out = encode(params, cfg, torch.from_numpy(enc).to(dev))
    _sync(dev)
    t0 = time.time()
    toks = prefill_then_decode(params, cfg, prompts, gen, enc_out=enc_out,
                               temperature=temperature)
    _sync(dev)
    dt = time.time() - t0
    n_new = batch * gen
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s batched, device={dev})")
    print("sample:", toks[0, :32].tolist())
    if toks.shape != (batch, prompt_len + gen):
        raise RuntimeError(f"decoded shape {tuple(toks.shape)}")
    return toks


@dataclass
class SAServeRun:
    """What one `serve_sa_queries` call built and served."""

    index: object                 # SuffixArrayIndex or SegmentedIndex
    patterns: list                # the served patterns, half planted
    planted: np.ndarray           # bool per pattern: cut from a document
    responses: list               # one Response per arrival, in order
    summary: dict                 # repro_torch.serve.summarize
    metrics: dict                 # SAServer.metrics.snapshot()
    store_status: str             # "hit" | "miss" | "stale" | "off"
    build_s: float                # seconds to build or restore the index
    warmup_shapes: int
    ingest: Optional[dict] = None  # docs, seconds, builds, merges, synced


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _builds() -> int:
    return counters().get("repro_torch.builds", 0)


def serve_sa_queries(cfg, *, n_chars: int, n_docs: int, n_queries: int,
                     pattern_len: int = 16, seed: int = 0,
                     store_dir: str | None = None,
                     query_batch: int | None = None,
                     offered_qps: float | None = None,
                     arrival: str | None = None,
                     coalesce_max_wait_us: float | None = None,
                     queue_depth: int | None = None,
                     overload_policy: str | None = None,
                     segments: int | None = None,
                     ingest: int | None = None,
                     device="cuda") -> SAServeRun:
    """Serve substring queries through the asynchronous serving tier.

    The corpus is `n_docs` seeded byte documents of ``n_chars // n_docs``
    tokens — the same documents, ingests and patterns as the JAX
    package's `serve_sa_queries` for the same seed. With a `store_dir`
    (flag or `cfg.store_dir`) the index is looked up in an `IndexStore`
    first: a warm restart *restores* it (no build at all) instead of
    rebuilding; a miss or stale entry is built and persisted.

    With ``segments=K`` (or ``cfg.segments``) the corpus is served as a
    `SegmentedIndex` of K segments (persisted through a
    `SegmentedIndexStore`), and ``ingest=M`` streams M extra documents
    through `add_docs` after the build: each ingest builds one segment,
    size-tiered compaction may merge more (the run reports both), and
    with a store one sync writes only the segments that changed.

    Traffic is open-loop: `make_arrivals` schedules ~`n_queries` seeded
    arrivals and an `SAServer` coalesces them under admission control,
    after a warmup pass over every batch bucket. Every served count is
    checked against the closed-loop `count_batch`, and every admitted
    planted pattern must hit; a mismatch raises `RuntimeError`.
    """
    from ..api import (IndexStore, SegmentedIndex, SegmentedIndexStore,
                       SuffixArrayIndex, corpus_fingerprint, encode_docs)
    from ..bsp.counters import BSPCounters
    from ..serve import SAServer, make_arrivals, run_open_loop, summarize
    from .mesh import make_sa_mesh, visible_devices

    dev = resolve_device(device)
    n_segments = int(segments if segments is not None
                     else getattr(cfg, "segments", 0))
    n_ingest = int(ingest if ingest is not None
                   else getattr(cfg, "ingest", 0))
    if n_ingest and not n_segments:
        raise ValueError("--ingest requires --segments > 0: the monolithic "
                         "index has no incremental ingest path")

    mesh = (make_sa_mesh(device=dev) if len(visible_devices(dev)) > 1
            else None)
    counters = BSPCounters() if mesh is not None else None
    opts = cfg.to_options(mesh=mesh, counters=counters)
    rng = np.random.default_rng(seed)
    doc_len = max(n_chars // max(n_docs, 1), pattern_len + 1)
    docs = [rng.integers(0, 256, size=doc_len) for _ in range(n_docs)]

    store_dir = store_dir if store_dir is not None else cfg.store_dir
    store = entry = None
    _sync(dev)
    t0 = time.perf_counter()
    if n_segments > 0:
        per = max(-(-n_docs // n_segments), 1)      # ceil(docs / segments)

        def build():
            return SegmentedIndex.from_docs(docs, opts, sigma=256,
                                            segment_docs=per, device=dev)
        if store_dir:
            store = SegmentedIndexStore(store_dir, device=dev)
            entry = f"corpus-n{n_chars}-d{n_docs}-s{seed}-seg{n_segments}"
            index, status = store.get_or_build(entry, build, options=opts)
            print(f"segment store: {status} (root={store.root}, "
                  f"entry={entry}, {store.stats()})")
        else:
            status, index = "off", build()
    elif store_dir:
        store = IndexStore(store_dir, device=dev)
        text, _, _ = encode_docs(docs)
        # one entry per corpus configuration, so alternating --smoke/full
        # (or batch/seed changes) coexist instead of going mutually stale
        entry = f"corpus-n{n_chars}-d{n_docs}-s{seed}"
        index, status = store.get_or_build(
            entry,
            lambda: SuffixArrayIndex.from_docs(docs, opts, sigma=256,
                                               device=dev),
            options=opts, corpus_sha=corpus_fingerprint(text))
        age = store.manifest_age(entry)
        print(f"index store: {status} (root={store.root}, entry={entry}, "
              f"manifest_age={age:.1f}s, {store.stats()})")
    else:
        status = "off"
        index = SuffixArrayIndex.from_docs(docs, opts, sigma=256, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    verb = "restored" if status == "hit" else "indexed"
    seg_note = (f", segments={index.n_segments}"
                if n_segments > 0 else "")
    print(f"{verb} {index.n} chars / {index.n_docs} docs in {build_s:.3f}s "
          f"(backend={opts.resolve_backend()}, device={dev}{seg_note}, "
          f"builds={_builds()})")

    ingested = None
    if n_ingest:
        b0, merges = _builds(), 0
        t0 = time.perf_counter()
        for _ in range(n_ingest):
            index.add_docs([rng.integers(0, 256, size=doc_len)],
                           compact=False)
            merges += index.compact()
        _sync(dev)
        ingested = {"docs": n_ingest, "seconds": time.perf_counter() - t0,
                    "builds": _builds() - b0, "merges": merges,
                    "segments": index.n_segments}
        line = (f"ingested {n_ingest} docs in {ingested['seconds']:.3f}s: "
                f"{ingested['builds']} segment builds ({merges} of them "
                f"compaction merges), segments={index.n_segments}")
        if store is not None:
            t0 = time.perf_counter()
            ingested.update(store.save(entry, index))
            ingested["sync_seconds"] = time.perf_counter() - t0
            line += (f", synced {ingested['segments_written']} segments "
                     f"(-{ingested['segments_deleted']} dropped) in "
                     f"{ingested['sync_seconds']:.3f}s")
        print(line)
    if counters is not None and counters.supersteps:
        from ..bsp.psort import resolve_bsp_sort_impl
        impl = resolve_bsp_sort_impl(opts.sort_impl, opts.pack_keys)
        print(f"bsp costs: S={counters.supersteps} supersteps over "
              f"{counters.rounds} distributed rounds, "
              f"H={counters.comm_words} words, W={counters.work} ops "
              f"(sort_impl={impl})")

    # half the queries are planted substrings (must hit), half random
    patterns, planted = [], np.zeros(n_queries, bool)
    for q in range(n_queries):
        if q % 2 == 0:
            d = rng.integers(0, n_docs)
            at = rng.integers(0, doc_len - pattern_len)
            patterns.append(docs[d][at:at + pattern_len])
            planted[q] = True
        else:
            patterns.append(rng.integers(0, 256, size=pattern_len))

    batch = int(query_batch if query_batch is not None else cfg.query_batch)
    qps = float(offered_qps if offered_qps is not None else cfg.offered_qps)
    proc = arrival if arrival is not None else cfg.arrival
    wait_us = float(coalesce_max_wait_us if coalesce_max_wait_us is not None
                    else cfg.coalesce_max_wait_us)
    depth = int(queue_depth if queue_depth is not None else cfg.queue_depth)
    policy = (overload_policy if overload_policy is not None
              else cfg.overload_policy)

    server = SAServer(index, max_batch=batch,
                      coalesce_max_wait_us=wait_us, queue_depth=depth,
                      overload_policy=policy,
                      gc_hygiene=cfg.gc_hygiene).start()
    try:
        t0 = time.perf_counter()
        shapes = server.warmup(pattern_lens=(pattern_len,))
        print(f"warmup: {shapes} batch shapes in "
              f"{time.perf_counter() - t0:.3f}s (excluded from percentiles)")
        # ~n_queries seeded open-loop arrivals at the offered rate
        arrivals = make_arrivals(proc, qps, n_queries / qps, seed=seed)
        t0 = time.perf_counter()
        responses = run_open_loop(server, patterns, arrivals)
        dt = time.perf_counter() - t0
    finally:
        server.stop()
    slo = summarize(responses, dt)

    # every admitted planted pattern hits, and every served count equals
    # the closed-loop engine's on the same index
    served = [(i % n_queries, r) for i, r in enumerate(responses) if r.ok]
    if any(planted[q] and r.count < 1 for q, r in served):
        raise RuntimeError("an admitted planted pattern was served a count "
                           "of 0")
    if served:
        want = index.count_batch([patterns[q] for q, _ in served])
        got = np.asarray([r.count for _, r in served], np.int64)
        if not np.array_equal(got, want):
            raise RuntimeError(
                f"{int((got != want).sum())} served counts differ from "
                f"count_batch on the same index")

    m = server.metrics.snapshot()
    lat = {k: (f"{v * 1e3:.0f}us" if v is not None else "absent")
           for k, v in [("p50", slo["p50_ms"]), ("p95", slo["p95_ms"]),
                        ("p99", slo["p99_ms"])]}
    print(f"served {slo['offered']} open-loop queries ({proc}@{qps:.0f} "
          f"offered qps) in {dt:.3f}s: ok={slo['ok']} "
          f"rejected={slo['rejected']} shed={slo['shed']} "
          f"goodput={slo['goodput_qps']:.0f} qps")
    print(f"latency p50={lat['p50']} p95={lat['p95']} p99={lat['p99']}; "
          f"coalesced batch mean={m['batch_size']['mean'] or 0:.1f} "
          f"occupancy={m['bucket_occupancy']['mean'] or 0:.2f} "
          f"(policy={policy}, queue_depth={depth}, "
          f"max_wait={wait_us:.0f}us)")
    return SAServeRun(index=index, patterns=patterns, planted=planted,
                      responses=responses, summary=slo, metrics=m,
                      store_status=status, build_s=build_s,
                      warmup_shapes=shapes, ingest=ingested)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve substring count queries over a seeded corpus "
                    "through the asynchronous serving tier, or decode "
                    "from a seeded language model (--arch <model>).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="20,000 corpus chars in place of cfg.n (LM: the "
                         "reduced same-family config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to build and serve on "
                         "(default: cuda)")
    ap.add_argument("--batch", type=int, default=4,
                    help="documents in the corpus (LM: prompts)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="pattern length (LM: prompt length)")
    ap.add_argument("--gen", type=int, default=32,
                    help="LM: tokens to decode after the prompt")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM: sampling temperature (0 = greedy)")
    ap.add_argument("--queries", type=int, default=64,
                    help="open-loop queries to serve")
    ap.add_argument("--store", default=None,
                    help="IndexStore root (a warm restart restores the "
                         "index instead of rebuilding)")
    ap.add_argument("--query-batch", type=int, default=None,
                    help="max coalesced batch (default: cfg.query_batch)")
    ap.add_argument("--offered-qps", type=float, default=None,
                    help="open-loop offered load (default: cfg.offered_qps)")
    ap.add_argument("--arrival", default=None,
                    choices=["uniform", "poisson", "onoff"],
                    help="arrival process (default: cfg.arrival)")
    ap.add_argument("--coalesce-max-wait-us", type=float, default=None,
                    help="batch-window deadline in µs "
                         "(default: cfg.coalesce_max_wait_us)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission bound on queued requests "
                         "(default: cfg.queue_depth)")
    ap.add_argument("--overload-policy", default=None,
                    choices=["none", "reject", "shed"],
                    help="behaviour past queue_depth (default: "
                         "cfg.overload_policy)")
    ap.add_argument("--segments", type=int, default=None,
                    help="serve a SegmentedIndex with this many segments "
                         "(default: cfg.segments; 0 = monolithic)")
    ap.add_argument("--ingest", type=int, default=None,
                    help="docs to stream through add_docs after the build "
                         "(requires --segments; default: cfg.ingest)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if getattr(cfg, "name", "") != "suffix-array":
        if args.smoke:
            cfg = cfg.smoke()
        return serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, temperature=args.temperature,
                        device=args.device)
    return serve_sa_queries(cfg, n_chars=20_000 if args.smoke else cfg.n,
                            n_docs=args.batch, n_queries=args.queries,
                            pattern_len=args.prompt_len,
                            store_dir=args.store,
                            query_batch=args.query_batch,
                            offered_qps=args.offered_qps,
                            arrival=args.arrival,
                            coalesce_max_wait_us=args.coalesce_max_wait_us,
                            queue_depth=args.queue_depth,
                            overload_policy=args.overload_policy,
                            segments=args.segments, ingest=args.ingest,
                            device=args.device)


if __name__ == "__main__":
    main()
