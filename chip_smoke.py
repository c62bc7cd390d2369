#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. Card: print `nvidia-smi`'s name and power limit, build the CUDA kernels
   from `src/repro_torch/kernels/csrc/` and print the build time.
2. Kernel against plain: every kernel on the card against its plain PyTorch
   version on the same inputs, integer outputs equal element for element
   (the one-stage bitonic kernel; every launch of the shared-memory sort's
   schedule, tile and cross-tile, at W = 3 .. 187 and N below, at and above
   the tile, keys total or a tied prefix; the radix histogram's digit
   loader at the TPU kernel's test sweeps and at N = 2^24; its key loader
   at shifts 0 .. 56, ragged and whole blocks of 1,024 and 4,096, the key
   families of `tests/torch_pass_keys.py` (random, constant, skewed and
   top-pass keys), N up to 2^24, and the offsets scanned from it against
   the staged route's;
   the scatter pass at blocks of 1,024 and 4,096 and the LSD argsort, also
   against stable `torch.sort` passes; both forms of the one-pass dense
   rank at N = 1, a tile less one, a tile, a tile and one, 2^20 + 3 and
   2^24, rows staged (W = 3) and read in place (W = 7), a key prefix, a
   constant run across 300 tiles, distinct rows, gathered rows of 1, 2,
   17 words and of the cap, positions sorted and permuted, each twice).
3. Main path at real size: a seeded corpus of 4,096 byte documents
   (sigma = 256, 14,667,776 encoded tokens; about 10% of the documents copy
   a 512-byte passage of another one) goes through
   `SuffixArrayIndex.from_docs` on the card with ``sort_impl="auto"``
   (= "radix" on a CUDA device: the radix sort and the gathered dense
   rank) and with an explicit ``sort_impl="kernel"`` (the bitonic sort and
   the rows form of the dense rank); both resolve their Lemma-1 ties with
   the radix kernels and `lemma1_merge`. Each build must have launched
   exactly its path's kernels (`PATH_KERNELS`); the SA must pass an O(n)
   check and every impl ("kernel", "radix", "torch") must give the same
   SA. Then five warm builds of the default plan, timed
   (``builds_s["default"]``).
4. Queries: 4,096 patterns of 32-512 tokens, half planted, through
   `count_batch` and `locate_batch`; every planted pattern hits, and 16
   counts equal a direct scan of the text on the card.
5. Sparse index, path (B): `from_docs` with ``sample_rate=16`` on the radix
   kernels. Its SA must equal the dense SA restricted to multiples of 16;
   on the phase-4 batch its counts and positions must equal the dense
   index's; a 15-token pattern must raise `PatternTooShortError`;
   `longest_match` of 4 planted sequences must equal the dense answer.
6. Kernel times at the main path's level-0 shapes, beside their bounds,
   the plain versions and one PyTorch library call; the radix histogram's
   key loader on random, constant and top-pass keys, its digit loader,
   and a level-0 pass's digit work the old way (digits staged in PyTorch,
   counted, transposed and scanned) beside the new (the key loader and
   one cumsum); the bitonic row sort at every level of one
   "kernel" build (the real window rows of each level), beside its bound,
   its launch count, the one-stage-per-launch schedule and `torch.sort` of
   the level's packed words; the dense rank's rows form on the level-0
   samples beside the `seg_boundary` + stitch route it replaced, and its
   gathered form at both call sites of every level of one default build
   beside the stock gathers and cumsum it replaced (one
   `{"dense_rank_level": ...}` line a level); `lemma1_merge` on the
   level-0 tie payload of one build of the infini-gram cell's corpus
   (`sabench/configs/infinigram-llama2.json`, 2^27 tokens), beside its
   bound, its plain version and the whole tie resolution of that level
   (the class sort, its gathers and the merge).
7. Trace: one more kernel-path build, one radix build and one sparse build
   under `torch.profiler`: device time by kernel and the device's idle
   share of each build's wall time.
8. Serving, every step on the card: (a) `SAServer(max_batch=64)` with the
   reference defaults (coalesce wait 500 us, queue depth 1024, policy
   "reject") over the phase-3 index, warmed over the phase-4 length
   buckets and driven by seeded Poisson arrivals at 2,000 qps over the
   phase-4 patterns: every future must resolve, every status be ok,
   rejected or shed, every ok count equal `count_batch`'s and every
   admitted planted pattern hit; the dense index once more at 1,000
   qps, below the server's capacity; beside it a closed-loop
   `QuerySession(batch_size=64)` rate, and ten of its ticks under
   `torch.profiler`; (b) the same over the phase-5 sparse index, its
   counts equal to the dense ones; (c) an
   `IndexStore` round trip of the phase-3 corpus (miss, then hit; the
   restored SA equal to the built SA; a changed corpus and a changed plan
   raise `StaleIndexError`) and of the sparse index; (d) the entry point
   `serve_sa_queries` at the default `SAConfig` (2^20 chars), monolithic
   with a store (cold, then a warm restart that builds nothing) and with
   8 segments, 4 ingests and a `SegmentedIndexStore` (one segment build
   per ingest plus compaction merges; counts equal to a monolithic index
   over the same documents), then `python -m repro_torch.launch.serve
   --arch suffix-array --smoke`. Each build launches exactly its path's
   kernels and serving launches none.
9. Data plane, every index on the card: `TrainingDataPlane` (dedup, the
   "reject" gate, compaction every 4 shards) streams 256 documents of
   4,096 chars in 8 shards (2^20 chars, 30% duplicated) against 32 eval
   documents, 8 of them carrying a copy of a training passage. The kept
   bytes must equal the monolithic `dedup_docs` and a host oracle (a set
   of seen 48-grams, no suffix array); each shard is one build plus its
   merges, and every segment build launches exactly the radix kernels;
   `batch_at(k)` for k = 0 .. 15 is deterministic; the gate's hits and
   masks on 64 windows equal a host set of the eval 48-grams; `probe()` of
   8 samples equals the same metrics over a monolithic index of the raw
   documents. Prints a `{"data_plane": ...}` line: chars/s of the stream
   and of `dedup_docs`, each shard's time by stage, the gate's windows/s,
   the probe's ms a sample, one traced shard ingest (``with_setup_s``: its
   side plane's earlier shards and the profiler's own processing too) and
   the phase's own wall time (``phase_s``).

10. The decoder-only LM at full width, on the SA data plane (phases 3-9's
   device state freed first): (a) `repro_torch.launch.train.main` trains
   gemma3-1b at its published widths (26 layers, d_model 1,152, vocab
   262,144, window 512; about 1.0 B parameters, AdamW in float32) for 4
   steps of 4 x 1,024 tokens, with dedup, the "mask" gate over 80 planted
   eval blocks and the probe every 2 steps: the loss must be finite and
   below ln(262,144) + 3, some step must mask targets and the gate must
   have masked windows, the dedup report must have builds == shards > 1,
   the probe must report samples, the plane's index builds must have
   launched exactly the radix kernels and the train steps none; (b) 8 more
   steps on one fixed batch (lr 3e-4, warmup 1): the last loss below the
   first; then one more step under `torch.profiler`; (c) greedy
   `prefill_then_decode` of 4 prompts of 520 tokens and 32 new tokens
   (past the window, so every local ring buffer wraps): each step's
   logits (the decode steps see the tokens a teacher-forced pass would)
   equal a full `forward_hidden` within 0.05 of the largest logit at every
   position; one decode step under `torch.profiler`; then `python -m
   repro_torch.launch.serve --arch gemma3-1b --batch 4 --prompt-len 16
   --gen 32`; (d) at ``smoke()`` the card's logits and loss equal the CPU
   path's (same params from one generator) within the CPU tests'
   tolerances, and the banded attention path at gemma3-1b's head shapes
   (2,048 tokens, window 512) equals the CPU's. Prints a ``{"lm": ...}``
   line: parameters, peak device memory, the train step's seconds (median
   of steps 2-4), tokens/s and 6·N·tokens/s, decode ms a step and
   tokens/s, the data plane's numbers and the phase's wall time.
11. The rest of the LM stack at published widths (phase 10's state freed
   first): (a) phi3.5-moe (d_model 4,096, 32 heads of 128 with 8 kv heads,
   16 experts of d_ff 6,400, top-2, capacity 1.3, vocab 32,064; AdamW in
   float32) with its depth cut from 32 to 2 layers (2.73 B parameters)
   trains 4 steps of 4 x 1,024 tokens through the trainer's own
   functions (`build_plane`, `lm_init`, `make_train_state`,
   `make_train_step`, `run_probe`) on phase 10's data plane: the plane's
   builds launch exactly the radix kernels and the steps none, the last
   loss is below ln(32,064) + 3, a step masks targets, the probe reports
   samples; then 4 rows decode 32 + 16 sampled tokens and each step's
   logits equal a full forward within 0.05 of the largest logit, both at
   a capacity that drops nothing (a capacity counts the tokens of its
   call, so where the forward drops an assignment the two differ by
   design; the forward's drop share at the config's capacity is printed);
   (b) recurrentgemma-2b (5 layers: one (r, r, l) period and the (r, r)
   tail), rwkv6-1.6b (2 layers) and whisper-small (whole, 1,500 encoder
   frames) at their published widths: one train step each on seeded
   tokens (2 x 1,024; whisper 2 x 448), one more rwkv6 step under
   `torch.profiler` (its kernel count), greedy decode of 16 + 16 tokens
   against the forward within 0.05; (c) the five new configs at smoke()
   on the card against the CPU path (same params): logits within 0.05 of
   the largest, losses within 1e-2. Prints a ``{"lm_kinds": ...}`` line:
   parameters, step seconds (phi: step 1 and the median of steps 2-4),
   tokens/s, peak device memory, the xent and aux losses and the share
   of token-expert assignments the capacities dropped, each step's, the
   decode errors and the phase's wall time.

12. Algorithm 3 on the card (run right after phase 9: it reuses phase
   3's index and phase 4's patterns, which are freed before phase 10):
   (a) `SuffixArrayIndex.from_docs` of the phase-3 corpus with
   ``SAOptions(mesh=make_sa_mesh(8, device="cuda"), sort_impl="auto")``,
   8 ranks sharing the card: its SA must equal the dense SA, its
   `count_batch` of the phase-4 patterns the dense counts, its launches
   exactly the "bsp" path's kernels, the mesh's rendezvous the
   supersteps less the base gathers, and every round 11 SM1 and 9 SM2
   supersteps; a cold and a warm build with each SM stage's host-clock
   seconds per level, the `BSPCounters` beside `estimate_costs`, rank 0's
   level-0 local sort on the radix kernels against their plain versions
   (and beside the `torch.sort` key sort), one warm build under
   `torch.profiler`; (b) at 2^20 tokens of the same generator,
   ``sort_impl="torch"`` and ``"bitonic"`` at p = 8 and ``"radix"`` at
   p = 3 must each equal the single-device SA; (c) the legacy
   single-device ``sort_impl="bitonic"`` too. Prints a ``{"bsp": ...}``
   line with the phase's wall time.

13. The dry run (`repro_torch.launch.dryrun`, `op_stats`) against the
   card (after phase 11, its state freed): (a) phase 10's gemma3-1b step
   and phase 11's phi3.5-moe step (2 layers), each at 4 x 1,024 tokens
   with its optimizer: the dry run's one-card argument bytes (parameters
   and optimizer state, from the specs on ``meta``) must equal the bytes
   of that state on the card, and its trip-count-scaled FLOP count on
   ``meta`` must equal the same counter over one real step on the card;
   then the counted FLOPs and ``model_flops``, the achieved TFLOP/s over
   phases 10/11's untraced step seconds of this run, the predicted peak
   (arguments + ``temp_size_in_bytes``) beside `max_memory_allocated` of
   one more step, and the FLOP split by part (attention, MLP or experts,
   unembedding); (b) `run_cell` of every arch at decode_32k and of
   gemma3-1b at train_4k, each with status "ok" and its seconds. Prints a
   ``{"dry_run": ...}`` line; launches no hand kernel.

14. The train state in the reference's layout (after phase 13, its state
   freed): (a) gemma3-1b at its published widths with Adafactor (the
   update over each stacked leaf: 4 periods of 6 layers as ``[4, ...]``
   leaves and the tail of 2 apart) through the trainer's own functions
   (`build_plane` with phase 10's arguments, `lm_init`,
   `make_train_state`, `make_train_step`, `save_checkpoint`,
   `restore_checkpoint`, `load_state_tree`) for 4 steps of 4 x 1,024
   tokens, a checkpoint in the reference's layout after step 2 (in a
   temporary directory, deleted after the phase), its manifest's paths,
   shapes and dtypes equal to the layout spelled from
   `convert.param_groups` on ``meta``; the checkpoint restored into a
   state of another seed and steps 3-4 run again, each loss within 1e-2
   of the straight run's (the embedding backward's atomics rule out bit
   equality); the plane's builds launch exactly the radix kernels and
   the steps none; (b) kimi-k2 at smoke (bf16 embedding, ``[2, ...]``
   leaves), 3 Adafactor steps on the card and on the CPU from the same
   params: each loss within 1e-2, every Adafactor leaf within 0.05 of its
   largest magnitude, and a checkpoint written on the card restores on
   the CPU with every parameter's bits equal. Prints a
   ``{"train_state": ...}`` line: step seconds, the stacked update's
   seconds a step, save and restore seconds, the checkpoint's bytes,
   peak memory, the losses and the phase's wall time.

Standard output ends with a JSON line of per-kernel numbers (each with
its launches on every path, ``launches_bsp`` for phase 12 (a)'s cold
build, ``launches_dryrun`` for phase 13's, 0, ``launches_train_state``
for phase 14's plane), the card's name and power limit, and ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_DOCS = 4096
DOC_LEN = 3580          # 4096 * 3581 = 14,667,776 tokens: level 0 pads to 2^24 rows
SIGMA = 256
PASSAGE = 512
COPY_SHARE = 0.10
N_PATTERNS = 4096
N_SCANNED = 16
SEED = 20261017
SPARSE_RATE = 16
N_LONGEST = 4
#: phase 3: warm builds of the default plan (``SAOptions()``), timed apart.
DEFAULT_WARM_BUILDS = 5

#: phase 8: the open-loop server's knobs (the reference defaults but for
#: max_batch) and the entry point's corpus (default SAConfig: 2^20 chars).
SERVE_QPS = 2000.0
#: a second dense run below the server's capacity (~1,700-1,850 qps on an
#: H100), whose latencies describe a steady queue, not a growing backlog.
SERVE_STEADY_QPS = 1000.0
SERVE_BATCH = 64
SERVE_DOCS = 64
SERVE_QUERIES = 2048
SERVE_SEGMENTS = 8
SERVE_INGEST = 4

#: phase 9: the data plane at the default SAConfig's corpus size (2^20
#: chars), in the generator and duplicate rate of
#: benchmarks/data_plane_bench.py: 256 documents of 4,096 chars, 32 a shard
#: (8 shards); 32 eval documents, 8 of them carrying a PASSAGE-char copy of
#: a training document; the reference's batch shape.
DP_CHARS = 1 << 20
DP_SHARD_DOCS = 32
DP_DOC_LEN = 4096
DP_DUP = 0.3
DP_SEED = 11
DP_EVAL_DOCS = 32
DP_PLANTED = 8
DP_SEQ_LEN = 512
DP_BATCH = 8
DP_STEPS = 16
DP_WINDOWS = 64
DP_PROBES = 8
DP_PROBE_LEN = 256
DP_TRACED_SHARD = 2

#: phase 10: the trainer's arguments (the published gemma3-1b widths, no
#: --smoke), the convergence run, the decode check and the smoke parity.
LM_ARCH = "gemma3-1b"
LM_SEQ_LEN = 1024
LM_BATCH = 4
#: 40 planted blocks (the reference's CI run) mask no window in the 4
#: seeded steps at these widths (dedup drops most of the overlapping
#: blocks); 80 mask one, in step 1.
LM_PLANTED = 80
LM_ARGV = ["--arch", LM_ARCH, "--steps", "4", "--seq-len", str(LM_SEQ_LEN),
           "--batch", str(LM_BATCH), "--dedup", "--eval-gate",
           "--gate-policy", "mask", "--plant-contamination", str(LM_PLANTED),
           "--probe-every", "2", "--device", "cuda"]
LM_CLI = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "16", "--gen",
          "32"]
LM_CLI_TOKENS = 4 * 32
LM_FIT_STEPS = 8
LM_FIT_LR = 3e-4
LM_PROMPT = 520
LM_GEN = 32
LM_REL = 0.05           # decode against forward; card against CPU
LM_LOSS_ABS = 1e-2
LM_BANDED_S = 2048

#: phase 11 (a): phi3.5-moe at its published widths, depth cut from 32 to 2
#: layers (a layer holds ~1.30 B parameters, 1.26 B of them in the 16
#: experts; with AdamW in float32 at 16 B a parameter a third layer would
#: pass 64 GB before activations), trained by the trainer's own functions
#: on phase 10's data plane; then a sampled decode against the forward.
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 2
MOE_ARGV = ["--arch", MOE_ARCH, "--steps", "4", "--seq-len", str(LM_SEQ_LEN),
            "--batch", str(LM_BATCH), "--dedup", "--eval-gate",
            "--gate-policy", "mask", "--plant-contamination", str(LM_PLANTED),
            "--probe-every", "2", "--device", "cuda"]
MOE_PROMPT = 32
MOE_GEN = 16
#: (b): the other new kinds at their published widths, one train step each
#: on seeded tokens, then greedy decode against the forward: (arch, layers
#: or None for the published depth, batch, decoder tokens). recurrentgemma
#: keeps one (r, r, l) period and the (r, r) tail, rwkv6 2 of 24 layers
#: (autograd keeps a [B, H, 64, 64] state a step); whisper-small is whole,
#: at its published decoder context of 448 and 1,500 encoder frames.
KIND_RUNS = (("recurrentgemma-2b", 5, 2, 1024), ("rwkv6-1.6b", 2, 2, 1024),
             ("whisper-small", None, 2, 448))
KIND_PROMPT = 16
KIND_GEN = 16
#: (c): the five configs of this slice at smoke(), the card against the CPU.
NEW_ARCHS = ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
             "rwkv6-1.6b", "whisper-small")

#: phase 13 (b): the dry run's cells run whole, one per arch at this shape
#: (one token a sequence: seconds each) and one train cell.
DRY_SHAPE = "decode_32k"
DRY_TRAIN_CELL = ("gemma3-1b", "train_4k")

#: phase 14: the train state. (a) Adafactor at phase 10's widths and
#: tokens on phase 10's plane: TS_STEPS steps straight, a checkpoint in the
#: reference's layout after TS_SAVE_AT of them, restored into a state of
#: another seed and run on; (b) kimi-k2 at smoke (its published widths are
#: 17.03 B parameters a layer), TS_SMOKE_STEPS Adafactor steps on the card
#: against the CPU, each Adafactor leaf within LM_REL of its largest
#: magnitude (the bf16 rule of the CPU tests).
TS_STEPS = 4
TS_SAVE_AT = 2
TS_SMOKE_ARCH = "kimi-k2-1t-a32b"
TS_SMOKE_STEPS = 3

#: phase 12: Algorithm 3 on a mesh of BSP_P ranks sharing the card; (b)
#: and (c) at 2^20 tokens (256 documents of 4,095 tokens and their
#: separators) of phase 3's generator.
BSP_P = 8
BSP_DOCS, BSP_DOC_LEN = 256, 4095
BSP_OTHER = (("torch", 8), ("bitonic", 8), ("radix", 3))

#: kernels each path must launch, and no others. The Lemma-1 tie resolution
#: of every keyed build (its class sort on the radix kernels, then
#: `lemma1_merge`) runs on each dense path; the sparse build has no Lemma-1
#: step.
PATH_KERNELS = {"kernel": {"bitonic_tile", "bitonic_cross", "dense_rank_rows",
                           "radix_hist", "radix_scatter", "lemma1_merge"},
                "radix": {"radix_hist", "radix_scatter", "dense_rank_gather",
                          "lemma1_merge"},
                "sparse": {"radix_hist", "radix_scatter", "dense_rank_gather"},
                "bsp": {"radix_hist", "radix_scatter", "dense_rank_gather",
                        "lemma1_merge"}}
#: what `SuffixArrayIndex.from_docs` launches before any of those: the
#: corpus layout (`api.index.stage_docs`). Every path checked below enters
#: through `from_docs`, except phase 12 (b)'s direct builds.
STAGE_KERNELS = {"encode_place"}
#: every kernel the builds of phase 8 must launch between them.
SERVING_KERNELS = PATH_KERNELS["radix"] | PATH_KERNELS["sparse"] | \
    STAGE_KERNELS

#: phase 6: the tie payload `lemma1_merge` is timed on, from one build of
#: the infini-gram cell's corpus at this seed.
LEMMA1_CONFIG = ROOT / "sabench" / "configs" / "infinigram-llama2.json"
LEMMA1_SEED = 2147483711

#: the key loader's sweep in phase 2: shifts, lengths (below one block,
#: whole and ragged blocks), blocks.
PASS_SHIFTS = (0, 8, 16, 40, 56)
PASS_NS = (1, 2, 999, 4096, 4097, 70_001, 2 ** 20 + 5, 2 ** 24)
PASS_BLOCKS = (1024, 4096)

#: HBM bandwidth (bytes/s) by card name, from NVIDIA's data sheets.
DRAM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                    ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def dram_bytes_per_s(name: str) -> float:
    for key, rate in DRAM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def time_ms(fn, dev, reps: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` runs after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    import torch
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def empty_cache(dev) -> None:
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plain_launch(rows, launch, num_keys=None, *, inplace=False):
    """`ops.bitonic_launch` on the plain version, on any device."""
    from repro_torch.kernels import ref
    out = ref.bitonic_stages_ref(rows, launch.stages(), num_keys)
    return rows.copy_(out) if inplace else out


def stage_sort(rows):
    """The full sort as one `bitonic_stage` launch per stage: the yardstick
    the fused launches of `ops.bitonic_sort` are timed against."""
    from repro_torch.kernels import ops
    n = rows.shape[0]
    out = rows.clone()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            ops.bitonic_stage(out, k, j, inplace=True)
            j //= 2
        k *= 2
    return out


def timed_once(fn, dev):
    """(milliseconds, result) of one call of fn(), without a warm-up."""
    import torch
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t0), out


def seg_boundary_stitch(rows, block: int = 512):
    """Dense ranks the way `ops.dense_rank_sorted` took them before the
    one-pass kernel: `seg_boundary` on rows padded to whole blocks, then a
    stitch of stock ops (an exclusive cumsum of the block totals, the
    edge-row compare, a second cumsum, the broadcast add). Timed beside the
    one-pass kernel."""
    import torch
    from repro_torch.kernels import ops
    n, w = rows.shape
    pad = (-n) % block
    rows_p = torch.cat([rows, rows[-1:].expand(pad, w)]) if pad else rows
    _, csum, totals = ops.seg_boundary(rows_p, w, block)
    nb = rows_p.shape[0] // block
    base = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    same = (rows_p[block - 1:-1:block] == rows_p[block::block]).all(dim=1)
    corr = torch.zeros(nb, dtype=torch.int32, device=rows.device)
    corr[1:] = torch.cumsum(same, 0, dtype=torch.int32)
    ranks = ((base - corr)[:, None] + csum.view(nb, block) - 1) \
        .reshape(-1)[:n]
    return ranks, ranks[-1] + 1


def stock_rank(words, pos):
    """The stock sequence the gathered dense rank replaced at both call
    sites of the "radix" build: `rows_neq` (two gathers and a compare a
    word), then an int64 cumsum. Returns (ranks, is_start)."""
    import torch
    from repro_torch.kernels import ref
    is_start = torch.ones(len(pos), dtype=torch.bool, device=pos.device)
    is_start[1:] = ref.rows_neq(words, pos[1:], pos[:-1])
    return torch.cumsum(is_start, 0) - 1, is_start


def gather_bytes(words, pos) -> int:
    """Bytes the gathered dense rank must move on these inputs: pos (8 a
    row), ranks and is_start (5 a row), and a 32-byte sector for each word
    a row needs: its words up to the first that differs from its
    predecessor's or its successor's, whichever comes later."""
    import torch
    n, k = len(pos), len(words)
    need = torch.zeros(n + 1, dtype=torch.int64, device=pos.device)
    if n > 1:
        first = torch.full((n - 1,), k, dtype=torch.int64, device=pos.device)
        same = torch.ones(n - 1, dtype=torch.bool, device=pos.device)
        for j, word in enumerate(words):
            neq = word[pos[1:]] != word[pos[:-1]]
            first[same & neq] = j + 1
            same &= ~neq
        need[1:n] = first
    sectors = int(torch.maximum(need[:-1], need[1:]).sum())
    return 13 * n + 32 * sectors


def zero_launches() -> None:
    from repro_torch.kernels import ops
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0


def launched(dev, path: str, launches: dict, staged: bool = True) -> None:
    """On the card, exactly the kernels of `path` must have launched, and
    the corpus layout's where the build came through `from_docs`
    (`staged`)."""
    if dev.type == "cuda":
        got = {k for k, v in launches.items() if v}
        want = PATH_KERNELS[path] | (STAGE_KERNELS if staged else set())
        assert got == want, (path, launches)


def scan_offsets(digits, n: int, block: int):
    """The radix sort's per-pass offsets (`ref.lsd_argsort`): per-block
    counts of the padded digits, scanned bin-major, on the plain version."""
    import torch
    from repro_torch.kernels import ref
    nb = -(-n // block)
    counts = ref.radix_histogram_ref(digits, 257, block)[:, :256]
    flat = counts.t().reshape(-1)
    return (torch.cumsum(flat, 0, dtype=torch.int32) - flat).view(256, nb)


def pass_digits(keys, shift: int, block: int):
    """int32 digits of one pass, padded to a whole block with bin 256."""
    import torch
    n = keys.shape[0]
    digits = torch.full((-(-n // block) * block,), 256, dtype=torch.int32,
                        device=keys.device)
    digits[:n] = (keys >> shift) & 255
    return digits


def key_families():
    """The key families of `tests/torch_pass_keys.py`, the module the card
    and CPU tests draw theirs from."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_pass_keys", ROOT / "tests" / "torch_pass_keys.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def require_equal(name: str, got, want) -> int:
    """Exact equality of two integer tensors; returns the max abs error."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: kernel differs from plain by {err}")
    return err


# --------------------------------------------------------------- phase 2
def kernels_against_plain(dev, scale: int = 1) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED)
    n = 16384 // scale
    for w in (2, 4, 9, 66):
        rows = torch.from_numpy(
            rng.integers(-5, 5, (n, w)).astype(np.int32)).to(dev)
        for k, j in ((2, 1), (64, 8), (4096 // scale, 128),
                     (n, n // 2), (n, 512 // scale)):
            for num_keys in (w, max(1, w // 2)):
                require_equal(f"bitonic_stage W={w} k={k} j={j}",
                              ops.bitonic_stage(rows, k, j, num_keys),
                              ref.bitonic_stage_ref(rows, k, j, num_keys))
    for n in (2 ** 10, 2 ** 20 // scale):
        rows = torch.from_numpy(
            rng.integers(-50, 50, (n, 4)).astype(np.int32)).to(dev)
        rows[:, 3] = torch.from_numpy(
            rng.permutation(n).astype(np.int32)).to(dev)
        got = ops.bitonic_sort(rows)
        with mock.patch.object(ops, "bitonic_launch", plain_launch):
            require_equal(f"bitonic_sort N={n}", got, ops.bitonic_sort(rows))
        require_equal(f"bitonic_sort N={n} (oracle)", got,
                      ref.bitonic_sort_ref(rows))
        require_equal(f"bitonic_sort N={n} (one stage a launch)", got,
                      stage_sort(rows))
    bitonic_launches_against_plain(dev, rng)
    n = 65536 // scale
    cases = {
        "random": ref.bitonic_sort_ref(torch.from_numpy(
            rng.integers(0, 3, (n, 3)).astype(np.int32))),
        "all_equal": torch.full((n, 3), 7, dtype=torch.int32),
        "all_distinct": torch.arange(n, dtype=torch.int32)[:, None]
        .repeat(1, 3),
    }
    for kind, rows in cases.items():
        rows = rows.to(dev)
        for num_keys in (None, 2):
            for g, w in zip(ops.seg_boundary(rows, num_keys),
                            ref.seg_boundary_ref(rows, num_keys)):
                require_equal(f"seg_boundary {kind}", g, w)
    dense_rank_against_plain(dev, scale)
    radix_against_plain(dev, scale)


def dense_rank_against_plain(dev, scale: int = 1) -> None:
    """Both forms of `dense_rank.cu` against their plain versions: N from
    one row to 2^24 (a tile less one, a tile, a tile and one), rows staged
    in shared memory (W = 3) and compared in place (W = 7), long and short
    runs, a key prefix, one constant run across 300 tiles, all rows
    distinct; gathered rows of 1, 2 and 17 words and of the cap's, their
    positions sorted and permuted. Each case runs twice in a row (the
    second call on fresh scratch)."""
    import torch
    from repro_torch.core.words import argsort_words
    from repro_torch.kernels import dense_rank, ops, ref
    tile = dense_rank.TILE_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED)
    ns = [n if n <= tile + 1 else n // scale
          for n in (1, tile - 1, tile, tile + 1, 2 ** 20 + 3, 2 ** 24)]
    checked = 0

    def rows_case(name, rows, num_keys):
        nonlocal checked
        want = ref.dense_rank_rows_ref(rows, num_keys)
        for _ in range(2):
            for got, w in zip(ops.dense_rank_sorted(rows, num_keys), want):
                require_equal(f"dense_rank_rows {name}", got, w)
            checked += 1

    def gather_case(name, words, pos):
        nonlocal checked
        want = ref.dense_rank_gathered_ref(words, pos)
        for _ in range(2):
            for got, w in zip(ops.dense_rank_gathered(words, pos), want):
                require_equal(f"dense_rank_gather {name}", got, w)
            checked += 1

    for n in ns:
        for w in (3, 7):
            for hi in (4, 1024):
                rows = ref.bitonic_sort_ref(torch.randint(
                    0, hi, (n, w), generator=g, device=dev,
                    dtype=torch.int32))
                for num_keys in (w, w - 1):
                    rows_case(f"N={n} W={w} hi={hi} keys={num_keys}", rows,
                              num_keys)
        for k, hi in ((1, 2 ** 45), (1, 64), (2, 16), (17, 2)):
            words = [torch.randint(0, hi, (2 * n,), generator=g, device=dev)
                     for _ in range(k)]
            pos = argsort_words(words, None, "torch")[::2].contiguous()
            gather_case(f"N={n} K={k} hi={hi}", words, pos)
            perm = torch.randperm(n, generator=g, device=dev)
            gather_case(f"N={n} K={k} hi={hi} permuted", words, pos[perm])
    n = 300 * tile + 17
    const = torch.full((n, 3), 5, dtype=torch.int32, device=dev)
    distinct = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .repeat(1, 3)
    for name, rows in (("constant", const), ("distinct", distinct)):
        rows_case(f"{name} N={n}", rows, 3)
        gather_case(f"{name} N={n}", [rows[:, 0].long()],
                    torch.arange(n, device=dev))
    k = dense_rank.MAX_WORDS
    for n in (tile + 1, 2 ** 16 + 5):
        words = [torch.zeros(n, dtype=torch.int64, device=dev)] * (k - 1)
        words.append(torch.randint(0, 2, (n,), generator=g, device=dev))
        gather_case(f"N={n} K={k} (the cap)", words,
                    argsort_words(words[-1:], None, "torch"))
    log(f"dense_rank against plain: {checked} launches equal")


def bitonic_launches_against_plain(dev, rng) -> None:
    """Every launch of the shared-memory sort's schedule against its stages
    applied one by one on the plain version: the window widths of the main
    path's levels and of repetitive texts, N below, at and above the tile,
    keys total or a tied prefix (where the copy rule acts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import bitonic_sort as bsort
    from repro_torch.kernels import ops
    checked = 0
    for w in (3, 4, 5, 6, 9, 15, 66, 187):
        t = bsort.tile_rows(2 ** 30, w)
        for n in (t // 2, t, 4 * t):
            for keys in ("all", "prefix"):
                hi = 2 if keys == "prefix" else 50
                num_keys = w if keys == "all" else max(1, w // 3)
                cur = torch.from_numpy(
                    rng.integers(-hi, hi, (n, w)).astype(np.int32)).to(dev)
                for launch in bsort.schedule(n, w):
                    want = plain_launch(cur, launch, num_keys)
                    require_equal(f"bitonic_{launch.kind} W={w} N={n} "
                                  f"k={launch.k_first} j={launch.j_hi}",
                                  ops.bitonic_launch(cur, launch, num_keys),
                                  want)
                    cur = want
                    checked += 1
    log(f"bitonic launches against plain: {checked} launches equal")


def radix_against_plain(dev, scale: int = 1) -> None:
    import numpy as np
    import torch
    from repro_torch.core.words import argsort_words
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED + 7)
    # the sweeps of tests/kernels/test_kernel_parity.py, then N = 2^24
    hist_cases = [(rng.integers(0, bins, n), bins, block) for n, bins, block
                  in ((1024, 256, 256), (2048, 8, 1024), (512, 2, 128),
                      (4096, 128, 512), (256, 16, 256), (128, 1, 64))]
    hist_cases += [
        (np.full(1024, 5), 8, 256),                                # constant
        (np.where(np.arange(2048) % 2 == 0, 0, 255), 256, 512),    # boundary
        (np.repeat(np.arange(8), 256), 8, 256),                    # skewed
        (rng.integers(0, 256, 2 ** 24 // scale), 256, 1024),
        (np.full(2 ** 24 // scale, 7), 256, 1024)]
    for digits, bins, block in hist_cases:
        d = torch.from_numpy(np.asarray(digits, np.int32)).to(dev)
        require_equal(f"radix_hist N={len(d)} bins={bins} block={block}",
                      ops.radix_histogram_blocks(d, bins, block),
                      ref.radix_histogram_ref(d, bins, block))
    families = key_families()
    checked = 0
    for n in PASS_NS:
        n = n if n <= 70_001 else n // scale
        for kind in families.PASS_KINDS:
            keys = torch.from_numpy(families.pass_keys(kind, n, rng)).to(dev)
            for block in PASS_BLOCKS:
                nb = -(-n // block)
                for shift in PASS_SHIFTS:
                    want = ref.radix_pass_counts_ref(keys, shift, block)
                    require_equal(f"radix_hist keys {kind} N={n} "
                                  f"block={block} shift={shift}",
                                  ops.radix_pass_counts(keys, shift, block),
                                  want)
                    checked += 1
                    require_equal(
                        f"pass offsets {kind} N={n} block={block} "
                        f"shift={shift} (staged route)",
                        torch.cumsum(want, 0, dtype=torch.int32)[:-1]
                        .view(256, nb),
                        scan_offsets(pass_digits(keys, shift, block), n,
                                     block))
    log(f"radix_hist key loader against plain: {checked} launches equal, "
        f"offsets equal to the staged route's")
    for n in (2 ** 20 // scale, 2 ** 20 // scale + 333):
        skewed = np.where(rng.random(n) < 0.9, 0, rng.integers(0, 256, n))
        for kind, keys in (("random", rng.integers(0, 2 ** 45, n)),
                           ("constant", np.full(n, 9 << 16)),
                           ("skewed", skewed << 16),
                           ("distinct", rng.permutation(n) << 16)):
            keys = torch.from_numpy(keys.astype(np.int64)).to(dev)
            for dtype in (torch.int32, torch.int64):
                payload = torch.arange(n, dtype=dtype, device=dev)
                for block in (1024, ref.SORT_BLOCK):
                    offsets = scan_offsets(pass_digits(keys, 16, block), n,
                                           block)
                    for g, w in zip(
                            ops.radix_scatter(keys, payload, 16, offsets,
                                              block),
                            ref.radix_scatter_ref(keys, payload, 16, offsets,
                                                  block)):
                        require_equal(f"radix_scatter {kind} {dtype} N={n} "
                                      f"block={block}", g, w)
    for n in (2 ** 20 // scale, 2 ** 20 // scale + 333):
        for kind, bits, words in (
                ("1-word", 45, [rng.integers(0, 2 ** 45, n)]),
                ("3-word", [12, 9, 3], [rng.integers(0, 40, n),
                                        rng.integers(0, 512, n),
                                        rng.integers(0, 8, n)]),
                ("62-bit", 62, [rng.integers(0, 2 ** 62, n)])):
            words = [torch.from_numpy(np.asarray(w, np.int64)).to(dev)
                     for w in words]
            got = ops.radix_argsort(words, bits)
            require_equal(f"radix_argsort {kind} N={n}", got,
                          ref.radix_argsort_ref(words, bits))
            require_equal(f"radix_argsort {kind} N={n} (torch.sort)", got,
                          argsort_words(words, bits, "torch"))


# --------------------------------------------------------------- phase 3
def make_corpus(n_docs: int, doc_len: int, seed: int):
    """Seeded byte documents; COPY_SHARE of them copy a PASSAGE-byte slice
    of another document, so the tie and Lemma-1 paths run at scale."""
    import numpy as np
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, SIGMA, (n_docs, doc_len))
    passage = min(PASSAGE, doc_len // 2)
    for d in rng.choice(n_docs, int(COPY_SHARE * n_docs), replace=False):
        src = (int(d) + 1 + int(rng.integers(n_docs - 1))) % n_docs
        a, b = rng.integers(0, doc_len - passage, 2)
        docs[d, b:b + passage] = docs[src, a:a + passage]
    return list(docs)


def check_suffix_array(text, sa) -> None:
    """O(n) check, independent of the build: `sa` is a permutation, and
    each adjacent pair (a, b) has (x[a], rank[a+1]) < (x[b], rank[b+1]),
    a suffix that runs out comparing low."""
    import torch
    n = len(text)
    sa = sa.long()
    assert bool((torch.bincount(sa, minlength=n) == 1).all()), "not a perm"
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=text.device)
    rank[sa] = torch.arange(n, device=text.device)
    a, b = sa[:-1], sa[1:]
    ok = (text[a] < text[b]) | ((text[a] == text[b])
                                & (rank[a + 1] < rank[b + 1]))
    assert bool(ok.all()), f"{int((~ok).sum())} adjacent pairs out of order"


def main_path(dev, docs):
    import torch
    from repro_torch.api import SAOptions, SuffixArrayIndex, build_suffix_array
    from repro_torch.core.compat import resolve_sort_impl
    from repro_torch.kernels import ops
    zero_launches()
    sync(dev)
    t0 = time.perf_counter()
    idx = SuffixArrayIndex.from_docs(docs, SAOptions(), device=dev)
    sync(dev)
    t_radix = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"main path: from_docs n={idx.n} docs={idx.n_docs} "
        f"sort_impl=auto({resolve_sort_impl('auto', dev)}) "
        f"build_s={t_radix:.3f} launches={launches}")
    launched(dev, "radix", launches)
    check_suffix_array(idx.text, idx.sa)

    # the explicit "kernel" path: the bitonic sort and the rows form of the
    # dense rank
    zero_launches()
    sync(dev)
    t0 = time.perf_counter()
    krn = SuffixArrayIndex.from_docs(docs, SAOptions(sort_impl="kernel"),
                                     device=dev)
    sync(dev)
    t_kernel = time.perf_counter() - t0
    kernel_launches = dict(ops.LAUNCHES)
    log(f"main path: from_docs sort_impl=kernel build_s={t_kernel:.3f} "
        f"launches={kernel_launches}")
    launched(dev, "kernel", kernel_launches)
    assert torch.equal(krn.sa, idx.sa), "sort_impl=kernel SA differs"
    for key in PATH_KERNELS["kernel"] - PATH_KERNELS["radix"]:
        launches[key] = kernel_launches[key]

    builds = {"kernel": [t_kernel], "radix": [t_radix], "torch": []}
    for impl in ("torch", "radix", "kernel", "kernel", "radix", "torch"):
        sync(dev)
        t0 = time.perf_counter()
        sa = build_suffix_array(idx.text, SAOptions(sort_impl=impl),
                                device=dev)
        sync(dev)
        builds[impl].append(time.perf_counter() - t0)
        assert torch.equal(sa, idx.sa), f"sort_impl={impl} SA differs"
    # the default plan, warm: the number to hold against another commit's
    # phase 3 (its "kernel" builds, where "auto" resolved to "kernel")
    builds["default"] = []
    for _ in range(DEFAULT_WARM_BUILDS):
        sync(dev)
        t0 = time.perf_counter()
        sa = build_suffix_array(idx.text, SAOptions(), device=dev)
        sync(dev)
        builds["default"].append(time.perf_counter() - t0)
        assert torch.equal(sa, idx.sa), "default build's SA differs"
    log(f"main path: SA passes the O(n) check; kernel, radix and torch "
        f"builds agree; build_s {json.dumps(builds)}")
    return idx, launches, builds


# --------------------------------------------------------------- phase 4
def scan_count(text, pat, chunk: int = 1 << 20) -> int:
    """Occurrences of `pat` by a direct scan of every window of the text."""
    wins = text.unfold(0, len(pat), 1)
    return sum(int((wins[a:a + chunk] == pat).all(dim=1).sum())
               for a in range(0, wins.shape[0], chunk))


def queries(dev, idx, docs, n_patterns: int, max_len: int = 512):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    doc_len = len(docs[0])
    lens = rng.integers(32, max_len + 1, n_patterns)
    planted = np.arange(n_patterns) % 2 == 0
    pats, where = [], {}
    for i, m in enumerate(lens):
        if planted[i]:
            d = int(rng.integers(len(docs)))
            off = int(rng.integers(0, doc_len - m + 1))
            pats.append(np.asarray(docs[d][off:off + m]))
            where[i] = int(idx.doc_starts[d]) + off
        else:
            pats.append(rng.integers(0, SIGMA, m))
    times = {}
    for run in ("first", "second"):
        t0 = time.perf_counter()
        counts = idx.count_batch(pats)
        times[f"count_{run}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    located = idx.locate_batch(pats)
    times["locate_s"] = time.perf_counter() - t0
    assert (counts[planted] >= 1).all(), "a planted pattern missed"
    assert all(len(p) == c for p, c in zip(located, counts))
    assert all(pos in located[i] for i, pos in where.items())
    text = idx.text.to(torch.int32)
    for i in list(range(N_SCANNED // 2)) + list(
            range(n_patterns - N_SCANNED // 2, n_patterns)):
        pat = torch.from_numpy(pats[i] + idx.shift).to(dev, torch.int32)
        assert scan_count(text, pat) == counts[i], f"pattern {i}"
    rate = {k[:-2] + "_patterns_per_s": n_patterns / v
            for k, v in times.items()}
    log(f"queries: {n_patterns} patterns (half planted, all hit; "
        f"{N_SCANNED} scan-checked) {json.dumps(rate)}")
    return rate, pats, counts, located


# --------------------------------------------------------------- phase 5
def sparse_path(dev, idx, docs, pats, counts, located) -> dict:
    """Path (B): the sampled-position index of the same corpus."""
    import numpy as np
    import torch
    from repro_torch.api import SAOptions, SuffixArrayIndex
    from repro_torch.kernels import ops
    from repro_torch.sparse import PatternTooShortError, SparseSuffixArrayIndex
    zero_launches()
    sync(dev)
    t0 = time.perf_counter()
    sp = SuffixArrayIndex.from_docs(
        docs, SAOptions(sample_rate=SPARSE_RATE), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"path (B): from_docs sample_rate={SPARSE_RATE} ns={sp.ns} "
        f"build_s={build_s:.3f} launches={launches}")
    assert type(sp) is SparseSuffixArrayIndex
    launched(dev, "sparse", launches)
    dense = idx.sa.long()
    assert torch.equal(sp.sa.long(), dense[dense % SPARSE_RATE == 0]), \
        "sparse SA is not the dense SA restricted to sampled positions"
    times = {}
    for run in ("first", "second"):
        t0 = time.perf_counter()
        sp_counts = sp.count_batch(pats)
        times[f"count_{run}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp_located = sp.locate_batch(pats)
    times["locate_s"] = time.perf_counter() - t0
    assert np.array_equal(sp_counts, counts), "sparse counts differ"
    assert all(np.array_equal(a, b) for a, b in zip(sp_located, located)), \
        "sparse positions differ"
    try:
        sp.count_batch([pats[0][:SPARSE_RATE - 1]])
    except PatternTooShortError:
        pass
    else:
        raise AssertionError("a 15-token pattern did not raise")
    rng = np.random.default_rng(SEED + 2)
    longest = []
    for i in range(N_LONGEST):
        d = docs[int(rng.integers(len(docs)))]
        m = int(rng.integers(64, 256))
        a = int(rng.integers(0, len(d) - m))
        seq = np.concatenate([rng.integers(0, SIGMA, 40), d[a:a + m],
                              rng.integers(0, SIGMA, 40)])
        want = idx.longest_match(seq)
        assert sp.longest_match(seq) == want >= m, (i, want, m)
        longest.append(want)
    out = {"build_s": build_s, "ns": sp.ns,
           "sa_bytes": sp.sa.numel() * sp.sa.element_size(),
           "dense_sa_bytes": idx.sa.numel() * idx.sa.element_size(),
           "longest_match": longest, "launches": launches,
           **{k[:-2] + "_patterns_per_s": len(pats) / v
              for k, v in times.items()}}
    log(f"path (B): sparse SA = dense SA at multiples of {SPARSE_RATE}; "
        f"{len(pats)} counts and positions equal dense; {json.dumps(out)}")
    return out, sp


# --------------------------------------------------------------- phase 6
def window_levels(dev, text) -> list:
    """(xp, n_v, v, lo, hi) of every level's window sort in one "kernel"
    build of `text`: the inputs the main path's row sort gets."""
    from repro_torch.api import SAOptions, build_suffix_array
    from repro_torch.core import dcv_torch
    seen = []
    window_order = dcv_torch.window_order

    def record(xp, n_v, v, lo, hi, impl):
        seen.append((xp, n_v, v, lo, hi))
        return window_order(xp, n_v, v, lo, hi, impl)

    with mock.patch.object(dcv_torch, "window_order", record):
        build_suffix_array(text, SAOptions(sort_impl="kernel"), device=dev)
    return seen


def library_sort(words):
    """One PyTorch library sort of a level's packed window words, and what
    it is."""
    import torch
    from repro_torch.core.words import argsort_words
    if len(words) == 1:
        return (lambda: torch.sort(words[0], stable=True),
                "torch.sort(stable=True) of the packed int64 window key")
    return (lambda: argsort_words(words, None, "torch"),
            f"{len(words)} stable torch.sort passes of packed keys")


def inplace_ms(fn, src, dev, reps: int = 5) -> float:
    """Mean milliseconds of fn(buf) on a fresh copy `buf` of `src` each
    time; the copy is not timed."""
    import torch
    buf = src.clone()
    fn(buf)
    total = 0.0
    for _ in range(reps):
        buf.copy_(src)
        sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(buf)
            end.record()
            torch.cuda.synchronize(dev)
            total += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn(buf)
            total += 1e3 * (time.perf_counter() - t0)
    return total / reps


def bitonic_levels(dev, levels, bandwidth: float) -> list[dict]:
    """The bitonic row sort on every level's window rows: its time, launch
    count and bound, beside the one-stage-per-launch schedule and a library
    sort of the level's packed words; each sort's order must equal the
    library's."""
    from repro_torch.core import dcv_torch
    from repro_torch.core.words import argsort_words
    from repro_torch.kernels import bitonic_sort as bsort
    from repro_torch.kernels import ops
    out = []
    for level, (xp, n_v, v, lo, hi) in enumerate(levels):
        rows = dcv_torch.window_rows(xp, n_v, v)
        n2, w = rows.shape
        words, bits = dcv_torch.window_words(xp, n_v, v, lo, hi)
        zero_launches()
        srt = ops.bitonic_sort(rows)
        n_launches = ops.LAUNCHES["bitonic_tile"] + \
            ops.LAUNCHES["bitonic_cross"]
        if dev.type == "cuda":
            assert n_launches == len(bsort.schedule(n2, w)), level
        err = require_equal(f"bitonic_sort level {level} (torch.sort order)",
                            srt[:n_v, v].long(),
                            argsort_words(words, bits, "torch"))
        require_equal(f"bitonic_sort level {level} (one stage a launch)",
                      srt, stage_sort(rows))
        lib_fn, lib_note = library_sort(words)
        entry = {"level": level, "n_v": n_v, "v": v, "rows": [n2, w],
                 "tile_rows": bsort.tile_rows(n2, w),
                 "launches": n_launches,
                 "stages": (n2.bit_length() - 1) * n2.bit_length() // 2,
                 "ms": time_ms(lambda: ops.bitonic_sort(rows), dev, reps=3),
                 "stage_per_launch_ms": time_ms(lambda: stage_sort(rows),
                                                dev),
                 "bound_ms": 1e3 * 2 * rows.numel() * 4 / bandwidth,
                 "library_ms": time_ms(lib_fn, dev, reps=3),
                 "library_call": lib_note, "max_abs_err": err}
        log(json.dumps({"bitonic_level": entry}))
        out.append(entry)
    return out


def bitonic_times(dev, level0, launches, bandwidth: float):
    """Level 0's row sort and each of its kernels, beside bound, plain and
    library; returns (kernel entries, sorted rows)."""
    from repro_torch.core import dcv_torch
    from repro_torch.kernels import bitonic_sort as bsort
    from repro_torch.kernels import ops
    xp, n_v, v, lo, hi = level0
    rows = dcv_torch.window_rows(xp, n_v, v)
    n2, w = rows.shape
    sched = bsort.schedule(n2, w)
    stages = (n2.bit_length() - 1) * n2.bit_length() // 2
    log(f"level 0: window rows int32[{n2}, {w}] (n_v={n_v}), {stages} "
        f"bitonic stages in {len(sched)} launches")
    one_pass_ms = 1e3 * 2 * rows.numel() * 4 / bandwidth
    lib_fn, lib_note = library_sort(
        dcv_torch.window_words(xp, n_v, v, lo, hi)[0])
    lib_sort_ms = time_ms(lib_fn, dev, reps=3)

    sort_ms = time_ms(lambda: ops.bitonic_sort(rows), dev, reps=3)
    out = ops.bitonic_sort(rows)
    with mock.patch.object(ops, "bitonic_launch", plain_launch):
        plain_sort_ms, plain_out = timed_once(lambda: ops.bitonic_sort(rows),
                                              dev)
    sort_err = require_equal("bitonic_sort level 0", out, plain_out)
    stage_ms = time_ms(lambda: stage_sort(rows), dev, reps=3)
    stage_err = require_equal("bitonic_stage sort level 0", stage_sort(rows),
                              plain_out)

    # one launch of each kind, on the rows the sort hands it
    cross = next(lc for lc in sched
                 if lc.kind == "cross" and lc.k_first == n2)
    merge = sched[-1]
    state, before = rows.clone(), {}
    for lc in sched:
        if lc in (sched[0], cross, merge):
            before[lc] = state.clone()
        ops.bitonic_launch(state, lc, inplace=True)
    per_launch = {}
    for name, lc in (("tile", sched[0]), ("cross", cross),
                     ("merge", merge)):
        src = before[lc]
        ms = inplace_ms(lambda b, lc=lc: ops.bitonic_launch(b, lc,
                                                            inplace=True),
                        src, dev)
        p_ms, want = timed_once(lambda: plain_launch(src, lc), dev)
        err = require_equal(f"bitonic_{lc.kind} level 0 "
                            f"k={lc.k_first} j={lc.j_hi}",
                            ops.bitonic_launch(src, lc), want)
        per_launch[name] = {"ms": ms, "plain_ms": p_ms, "err": err,
                            "stages": len(lc.stages())}
        del src

    # a tile launch with no stages: the HBM round trip alone, beside a clone
    t = sched[0].rows
    copy_only = bsort.Launch("tile", 2 * t, t, t // 2, 1, t, t)
    copy_ms = inplace_ms(lambda b: ops.bitonic_launch(b, copy_only,
                                                      inplace=True), rows, dev)
    clone_ms = time_ms(lambda: rows.clone(), dev, reps=5)

    src = "src/repro_torch/kernels/csrc/"
    tile, cr, mg = per_launch["tile"], per_launch["cross"], \
        per_launch["merge"]
    entries = [
        {"name": "bitonic_stage", "route": "cuda",
         "source": src + "bitonic_stage.cu",
         "replaces": "src/repro/kernels/bitonic_stage.py:52",
         "also_replaces": "src/repro/kernels/bitonic_stage.py:34",
         "launches": launches["bitonic_stage"], "max_abs_err": stage_err,
         "function": f"bitonic sort of int32[{n2}, {w}] level-0 window rows "
                     f"one stage a launch ({stages} launches; off the main "
                     f"path, which runs bitonic_tile and bitonic_cross)",
         "ms": stage_ms, "plain_ms": plain_sort_ms,
         "bound_ms": one_pass_ms, "bound_by": "bytes",
         "library_ms": lib_sort_ms, "library_call": lib_note,
         "per_launch_ms": stage_ms / stages},
        {"name": "bitonic_tile", "route": "cuda",
         "source": src + "bitonic_sort.cu",
         "replaces": "src/repro/kernels/bitonic_stage.py:52",
         "launches": launches["bitonic_tile"], "max_abs_err": tile["err"],
         "function": f"one launch: every stage k <= {sched[0].rows} "
                     f"({tile['stages']} stages) on int32[{n2}, {w}] "
                     f"level-0 window rows, tiles of {sched[0].rows} rows",
         "ms": tile["ms"], "plain_ms": tile["plain_ms"],
         "bound_ms": one_pass_ms, "bound_by": "bytes", "library_ms": None,
         "merge_ms": mg["ms"], "merge_plain_ms": mg["plain_ms"],
         "merge_function": f"the in-tile merge launch of k = {n2} "
                           f"({mg['stages']} stages)",
         "merge_max_abs_err": mg["err"], "copy_only_ms": copy_ms,
         "clone_ms": clone_ms},
        {"name": "bitonic_cross", "route": "cuda",
         "source": src + "bitonic_sort.cu",
         "replaces": "src/repro/kernels/bitonic_stage.py:34",
         "launches": launches["bitonic_cross"], "max_abs_err": cr["err"],
         "function": f"one launch: stages k = {n2}, j = {cross.j_hi} .. "
                     f"{cross.j_lo} ({cr['stages']} levels) on the level-0 "
                     f"window rows, runs of {cross.run} rows",
         "ms": cr["ms"], "plain_ms": cr["plain_ms"],
         "bound_ms": one_pass_ms, "bound_by": "bytes", "library_ms": None},
        {"name": "bitonic_sort", "route": "cuda",
         "source": "src/repro_torch/kernels/ops.py (bitonic_sort) on "
                   + src + "bitonic_sort.cu",
         "replaces": "src/repro/kernels/bitonic_stage.py:52",
         "replaces_note": "the driver of bitonic_tile and bitonic_cross; "
                          "its launches are theirs",
         "launches": launches["bitonic_tile"] + launches["bitonic_cross"],
         "max_abs_err": sort_err,
         "function": f"bitonic_sort of int32[{n2}, {w}] level-0 window rows "
                     f"({len(sched)} launches)",
         "ms": sort_ms, "plain_ms": plain_sort_ms,
         "bound_ms": one_pass_ms, "bound_by": "bytes",
         "library_ms": lib_sort_ms, "library_call": lib_note},
    ]
    return entries, out


def kernel_times(dev, levels, launches, bandwidth: float):
    import torch
    from repro_torch.core import dcv_torch
    from repro_torch.core.words import argsort_words
    from repro_torch.kernels import ops, ref
    bitonic, out = bitonic_times(dev, levels[0], launches, bandwidth)
    lib_sort_ms = bitonic[-1]["library_ms"]
    lib_note = bitonic[-1]["library_call"]
    xp, n_v, v, lo, hi = levels[0]
    words, bits = dcv_torch.window_words(xp, n_v, v, lo, hi)
    block = ref.SORT_BLOCK

    # Step-1 sample rows of level 0, in window-sorted order
    order = out[:n_v, v].long()
    in_d = dcv_torch.cover_constants(v, dev)[1]
    samples = out[:n_v, :v][in_d[order % v]].contiguous()
    m = samples.shape[0]
    rank_ms = time_ms(lambda: ops.dense_rank_sorted(samples), dev, reps=20)
    ranks, n_distinct = ops.dense_rank_sorted(samples)
    plain_rank_ms = time_ms(lambda: ref.dense_rank_rows_ref(samples), dev,
                            reps=3)
    want, want_nd = ref.dense_rank_rows_ref(samples)
    rank_err = require_equal("dense_rank_sorted level 0", ranks, want)
    assert int(n_distinct) == int(want_nd)
    stitch_ms = time_ms(lambda: seg_boundary_stitch(samples), dev, reps=20)
    require_equal("seg_boundary + stitch level 0",
                  seg_boundary_stitch(samples)[0], want)
    lib_rank_ms = time_ms(lambda: torch.unique_consecutive(
        samples, dim=0, return_inverse=True), dev, reps=3)
    rank_bytes = samples.numel() * 4 + m * 4
    pad = (-m) % 512
    padded = torch.cat([samples, samples[-1:].expand(pad, v)])
    seg_ms = time_ms(lambda: ops.seg_boundary(padded), dev, reps=20)
    plain_seg_ms = time_ms(lambda: ref.seg_boundary_ref(padded), dev, reps=3)
    seg_err = max(require_equal("seg_boundary level 0", g, w) for g, w in
                  zip(ops.seg_boundary(padded), ref.seg_boundary_ref(padded)))
    seg_bytes = padded.numel() * 4 + 2 * padded.shape[0] * 4 \
        + padded.shape[0] // 512 * 4
    del padded

    # radix: one pass of the level-0 window word, then the whole argsort
    keys = words[0]
    nb = -(-n_v // block)
    counts_ms = time_ms(lambda: ops.radix_pass_counts(keys, 0, block), dev,
                        reps=10)
    counts = ops.radix_pass_counts(keys, 0, block)
    plain_counts_ms = time_ms(lambda: ref.radix_pass_counts_ref(keys, 0,
                                                                block), dev)
    hist_err = require_equal("radix_hist key loader level 0", counts,
                             ref.radix_pass_counts_ref(keys, 0, block))
    slots = 1 + (keys & 255) * nb + torch.arange(n_v, device=dev) // block
    lib_hist_ms = time_ms(lambda: torch.bincount(slots,
                                                 minlength=counts.numel()),
                          dev, reps=10)
    del slots
    pass_bytes = n_v * 8 + counts.numel() * 4
    # the key loader on one constant key and on the word's top pass (shift
    # 40 of 45 bits: 32 digits)
    const = torch.full_like(keys, 7)
    top = 8 * (-(-bits[0] // 8) - 1)
    for what, k, sh in (("constant", const, 0), ("top_pass", keys, top)):
        require_equal(f"radix_hist key loader level 0 {what}",
                      ops.radix_pass_counts(k, sh, block),
                      ref.radix_pass_counts_ref(k, sh, block))
    constant_ms = time_ms(lambda: ops.radix_pass_counts(const, 0, block), dev,
                          reps=10)
    top_pass_ms = time_ms(lambda: ops.radix_pass_counts(keys, top, block),
                          dev, reps=10)
    del const

    # the digit loader (the TPU kernel's contract) on the staged digits
    digits = pass_digits(keys, 0, block)
    digit_ms = time_ms(lambda: ops.radix_histogram_blocks(digits, 257, block),
                       dev, reps=10)
    digit_err = require_equal("radix_hist digit loader level 0",
                              ops.radix_histogram_blocks(digits, 257, block),
                              ref.radix_histogram_ref(digits, 257, block))
    digit_bytes = digits.numel() * 4 + nb * 257 * 4

    # a pass's digit work (shift 8), the old staged way and the new way
    staged = digits.clone()
    scan = torch.empty(256 * nb + 1, dtype=torch.int32, device=dev)

    def old_pass():
        staged[:n_v] = (keys >> 8) & 255
        flat = ops.radix_histogram_blocks(staged, 257, block)[:, :256] \
            .t().reshape(-1)
        return (torch.cumsum(flat, 0, dtype=torch.int32) - flat).view(256, nb)

    def new_pass():
        torch.cumsum(ops.radix_pass_counts(keys, 8, block), 0,
                     dtype=torch.int32, out=scan)
        return scan[:-1].view(256, nb)

    require_equal("pass offsets level 0 (staged route)", new_pass(),
                  old_pass())
    pass_work = {"old_ms": [], "new_ms": []}
    for way in ("old", "new", "new", "old"):
        pass_work[f"{way}_ms"].append(
            time_ms(old_pass if way == "old" else new_pass, dev, reps=10))
    del staged, scan

    offsets = scan_offsets(digits, n_v, block)
    del digits
    payload = torch.arange(n_v, dtype=torch.int32, device=dev)
    scat_ms = time_ms(lambda: ops.radix_scatter(keys, payload, 0, offsets,
                                                block), dev, reps=10)
    got = ops.radix_scatter(keys, payload, 0, offsets, block)
    plain_scat_ms = time_ms(lambda: ref.radix_scatter_ref(
        keys, payload, 0, offsets, block), dev)
    want = ref.radix_scatter_ref(keys, payload, 0, offsets, block)
    scat_err = max(require_equal("radix_scatter level 0", g, w)
                   for g, w in zip(got, want))

    def library_pass():
        order = torch.sort(keys & 255, stable=True).indices
        return keys[order], payload[order]

    for g, w in zip(got, library_pass()):
        require_equal("radix_scatter level 0 (stable torch.sort pass)", g, w)
    lib_scat_ms = time_ms(library_pass, dev, reps=10)
    scat_bytes = 2 * n_v * (8 + 4) + offsets.numel() * 4
    # the same kernel at the previous block of 1,024 elements
    off_1024 = scan_offsets(pass_digits(keys, 0, 1024), n_v, 1024)
    scat_1024_ms = time_ms(lambda: ops.radix_scatter(keys, payload, 0,
                                                     off_1024, 1024),
                           dev, reps=10)

    argsort_ms = time_ms(lambda: ops.radix_argsort(words, bits), dev, reps=5)
    order0 = ops.radix_argsort(words, bits)
    plain_argsort_ms = time_ms(lambda: ref.radix_argsort_ref(words, bits),
                               dev)
    require_equal("radix_argsort level 0 (plain)", order0,
                  ref.radix_argsort_ref(words, bits))
    argsort_err = require_equal("radix_argsort level 0 (torch.sort)", order0,
                                argsort_words(words, bits, "torch"))
    passes = sum(-(-b // 8) for b in bits)
    argsort_bytes = n_v * 8 * (len(words) + 1)
    log(f"level 0 radix: word bits {bits}, {passes} passes, "
        f"{nb} blocks of {block}")

    src = "src/repro_torch/kernels/csrc/"
    no_tpu = "src/repro/core/dcv_jax.py:170"
    return bitonic + [
        {"name": "seg_boundary", "route": "cuda",
         "source": src + "seg_boundary.cu",
         "replaces": "src/repro/kernels/seg_boundary.py:18",
         "launches": launches["seg_boundary"], "max_abs_err": seg_err,
         "function": f"the TPU kernel's contract alone: per-512-row-block "
                     f"flags, in-block cumsums and totals of int32[{m}, {v}] "
                     f"level-0 sample rows padded to a whole block (off every "
                     f"path)",
         "ms": seg_ms, "plain_ms": plain_seg_ms,
         "bound_ms": 1e3 * seg_bytes / bandwidth, "bound_by": "bytes",
         "library_ms": None},
        {"name": "dense_rank_rows", "route": "cuda",
         "source": src + "dense_rank.cu",
         "replaces": "src/repro/kernels/seg_boundary.py:18",
         "replaces_note": "_seg_kernel and the stitch of "
                          "repro.kernels.ops.dense_rank_sorted, in one launch",
         "launches": launches["dense_rank_rows"], "max_abs_err": rank_err,
         "function": f"dense_rank_sorted of int32[{m}, {v}] level-0 sample "
                     f"rows (one launch)",
         "ms": rank_ms, "plain_ms": plain_rank_ms,
         "bound_ms": 1e3 * rank_bytes / bandwidth, "bound_by": "bytes",
         "library_ms": lib_rank_ms,
         "library_call": "torch.unique_consecutive(rows, dim=0, "
                         "return_inverse=True)",
         "seg_boundary_stitch_ms": stitch_ms},
        {"name": "radix_hist", "route": "cuda",
         "source": src + "radix_hist.cu",
         "replaces": "src/repro/kernels/radix_hist.py:20",
         "launches": launches["radix_hist"], "max_abs_err": hist_err,
         "function": f"key loader: one pass's bin-major digit counts of "
                     f"int64[{n_v}] level-0 keys (shift 0), blocks of "
                     f"{block}, into int32[{counts.numel()}]",
         "ms": counts_ms, "plain_ms": plain_counts_ms,
         "bound_ms": 1e3 * pass_bytes / bandwidth, "bound_by": "bytes",
         "library_ms": lib_hist_ms,
         "library_call": "torch.bincount(1 + digit * nb + block_id, "
                         "minlength=256 * nb + 1) on precomputed ids",
         "constant_digits_ms": constant_ms, "top_pass_ms": top_pass_ms,
         "digit_loader_ms": digit_ms,
         "digit_loader_bound_ms": 1e3 * digit_bytes / bandwidth,
         "digit_loader_max_abs_err": digit_err,
         "digit_loader_function": f"per-block histograms of "
                                  f"int32[{nb * block}] staged level-0 "
                                  f"digits, 257 bins (256 + pad)",
         "pass_digit_work": pass_work},
        {"name": "radix_scatter", "route": "cuda",
         "source": src + "radix_scatter.cu", "replaces": no_tpu,
         "replaces_note": "no TPU kernel: the JAX radix impl sorts on the "
                          "host in numpy (_order_from_words)",
         "launches": launches["radix_scatter"], "max_abs_err": scat_err,
         "function": f"one stable 8-bit pass of int64[{n_v}] level-0 keys "
                     f"with an int32 payload, blocks of {block}",
         "ms": scat_ms, "plain_ms": plain_scat_ms,
         "bound_ms": 1e3 * scat_bytes / bandwidth, "bound_by": "bytes",
         "library_ms": lib_scat_ms,
         "library_call": "torch.sort(keys & 255, stable=True) and the "
                         "gather of keys and payload by its indices",
         "block_1024_ms": scat_1024_ms},
        {"name": "radix_argsort", "route": "cuda",
         "source": "src/repro_torch/kernels/ref.py (lsd_argsort) on "
                   + src + "radix_hist.cu + radix_scatter.cu",
         "replaces": no_tpu,
         "replaces_note": "a driver of the two kernels above; its launches "
                          "are those of radix_scatter (one per pass)",
         "launches": launches["radix_scatter"], "max_abs_err": argsort_err,
         "function": f"LSD argsort of the level-0 window word "
                     f"(int64[{n_v}], {bits} bits, {passes} passes)",
         "ms": argsort_ms, "plain_ms": plain_argsort_ms,
         "bound_ms": 1e3 * argsort_bytes / bandwidth, "bound_by": "bytes",
         "library_ms": lib_sort_ms, "library_call": lib_note},
    ]


def default_build_ranks(dev, text) -> list:
    """(level, site, words, pos) of every `dense_rank_gathered` call in one
    "radix" build of `text` (the default on the card): each level's
    window-order run starts ("window", pos the whole order) and Step-1
    sample ranks ("samples")."""
    from repro_torch.api import SAOptions, build_suffix_array
    from repro_torch.core import dcv_torch
    seen = []
    gathered = dcv_torch.dense_rank_gathered

    def record(words, pos):
        site = "window" if pos.numel() == words[0].numel() else "samples"
        level = sum(c[1] == "window" for c in seen) - (site == "samples")
        seen.append((level, site, words, pos))
        return gathered(words, pos)

    with mock.patch.object(dcv_torch, "dense_rank_gathered", record):
        build_suffix_array(text, SAOptions(sort_impl="radix"), device=dev)
    return seen


def dense_rank_gather_times(dev, calls, launches, bandwidth: float) -> dict:
    """The gathered dense rank at both call sites of every level of a
    "radix" build, against the stock sequence it replaced (one
    `{"dense_rank_level": ...}` line a level), and level 0's kernel entry."""
    from repro_torch.kernels import ops, ref
    levels: dict[int, dict] = {}
    for level, site, words, pos in calls:
        got = ops.dense_rank_gathered(words, pos)
        want = stock_rank(words, pos)
        err = max(require_equal(f"dense_rank_gather level {level} {site}",
                                g, w)
                  for g, w in zip((got[0].long(), got[1]), want))
        levels.setdefault(level, {})[site] = {
            "rows": len(pos), "words": len(words),
            "kernel_ms": time_ms(lambda: ops.dense_rank_gathered(words, pos),
                                 dev, reps=10),
            "stock_ms": time_ms(lambda: stock_rank(words, pos), dev, reps=10),
            "bound_ms": 1e3 * gather_bytes(words, pos) / bandwidth,
            "max_abs_err": err}
    for level, sites in sorted(levels.items()):
        log(json.dumps({"dense_rank_level": {"level": level, **sites}}))
    (_, _, words, order), (_, _, _, sp) = calls[:2]
    window, samples = levels[0]["window"], levels[0]["samples"]
    plain_ms = time_ms(lambda: ref.dense_rank_gathered_ref(words, order),
                       dev, reps=3)
    for g, w in zip(ops.dense_rank_gathered(words, order),
                    ref.dense_rank_gathered_ref(words, order)):
        require_equal("dense_rank_gather level 0 (plain)", g, w)
    return {
        "name": "dense_rank_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_rank.cu",
        "replaces": "src/repro/kernels/seg_boundary.py:18",
        "replaces_note": "the same function as _seg_kernel + stitch, on rows "
                         "gathered through an order; in the reference's "
                         "radix build it is numpy (src/repro/core/"
                         "dcv_jax.py:256 _rows_neq)",
        "launches": launches["dense_rank_gather"],
        "max_abs_err": max(window["max_abs_err"], samples["max_abs_err"]),
        "function": f"run starts and dense ranks of the level-0 window order "
                    f"(int64[{window['rows']}] positions into "
                    f"{window['words']} packed word(s))",
        "ms": window["kernel_ms"], "plain_ms": plain_ms,
        "bound_ms": window["bound_ms"], "bound_by": "bytes",
        "library_ms": window["stock_ms"],
        "library_call": "the stock sequence it replaced: rows_neq (two "
                        "gathers and a compare a word) and torch.cumsum",
        "samples_function": f"level-0 Step-1 sample ranks "
                            f"(int64[{len(sp)}] positions)",
        "samples_ms": samples["kernel_ms"],
        "samples_bound_ms": samples["bound_ms"],
        "samples_library_ms": samples["stock_ms"]}


# --------------------------------------------------------------- phase 7
def cell_tie_payloads(dev, config=LEMMA1_CONFIG, seed: int = LEMMA1_SEED):
    """One default build of a `sabench` cell's corpus, its Lemma-1 step
    recorded: (the arguments of each `lemma1_order` call, of each
    `lemma1_merge` call), each list by level, level 0 first (the
    recursion resolves the deepest level's ties first)."""
    from repro_torch.api import SuffixArrayIndex
    from repro_torch.core import dcv_torch, words
    sys.path.insert(0, str(ROOT))
    from sabench import corpus
    data = corpus.make_corpus(json.loads(Path(config).read_text()), seed, dev)
    orders, merges = [], []
    order, merge = dcv_torch.lemma1_order, words.lemma1_merge

    def record_order(*args):
        orders.append(args)
        return order(*args)

    def record_merge(*args):
        merges.append(args)
        return merge(*args)

    with mock.patch.object(dcv_torch, "lemma1_order", record_order), \
            mock.patch.object(words, "lemma1_merge", record_merge):
        SuffixArrayIndex.from_docs(data.docs, device=dev)
    sync(dev)
    return orders[::-1], merges[::-1]


def lemma1_merge_times(dev, launches, bandwidth: float) -> dict:
    """`lemma1_merge` on the level-0 tie payload of the infini-gram cell's
    corpus against its plain version and its bound, beside the whole tie
    resolution of that level (`lemma1_order`: the class sort, its gathers
    and the merge); one `{"lemma1_level": ...}` line a level."""
    from repro_torch.core.words import lemma1_order
    from repro_torch.kernels import ops, ref
    orders, merges = cell_tie_payloads(dev)
    for level, (args, margs) in enumerate(zip(orders, merges)):
        log(json.dumps({"lemma1_level": {
            "level": level, "rows": int(margs[0].numel()),
            "v": int(margs[5].shape[0]), "widest": int(margs[4].max()),
            "order_ms": time_ms(lambda a=args: lemma1_order(*a),
                                dev, reps=5),
            "merge_ms": time_ms(lambda a=margs: ops.lemma1_merge(*a), dev,
                                reps=5)}}))
    args, margs = orders[0], merges[0]
    rows = int(margs[0].numel())
    dsize = int(margs[2].shape[1])
    ms = time_ms(lambda: ops.lemma1_merge(*margs), dev, reps=20)
    plain_ms = time_ms(lambda: ref.lemma1_merge_ref(*margs), dev, reps=2)
    err = require_equal("lemma1_merge level 0", ops.lemma1_merge(*margs),
                        ref.lemma1_merge_ref(*margs))
    require_equal("lemma1 order level 0", lemma1_order(*args),
                  ops.lemma1_merge(*margs))
    order_ms = time_ms(lambda: lemma1_order(*args), dev, reps=5)
    # p, klass, lane, width read and out written (8 bytes each), and each
    # row's rvals once
    merge_bytes = rows * (40 + 8 * dsize)
    del orders, merges, args, margs
    empty_cache(dev)
    return {"name": "lemma1_merge", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lemma1_merge.cu",
            "replaces": None,
            "replaces_note": "no TPU kernel: the JAX package breaks ties "
                             "with a comparator-bitonic network in jnp "
                             "(src/repro/core/dcv_jax.py, "
                             "_lambda_tiebreak_jit)",
            "launches": launches.get("lemma1_merge", 0),
            "max_abs_err": err,
            "function": f"Lemma-1 merge of the level-0 ties of one build of "
                        f"the infini-gram cell's corpus (seed "
                        f"{LEMMA1_SEED}): {rows} rows, |D| = {dsize}",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * merge_bytes / bandwidth, "bound_by": "bytes",
            "level_order_ms": order_ms, "library_ms": None,
            "library_call": "none: no PyTorch call merges by a comparator"}


def encode_place_times(dev, launches, bandwidth: float,
                       config=LEMMA1_CONFIG, seed: int = LEMMA1_SEED) -> dict:
    """`encode_place` on the infini-gram cell's corpus (its documents back
    to back, as `stage_docs` uploads them) against its plain version and
    its bound, beside the whole staging of those documents on the host
    clock (`stage_docs`: the lengths, the concatenate into pinned memory,
    the copy, the kernel and the flag's read)."""
    import torch
    from repro_torch.api.index import stage_docs
    from repro_torch.kernels import ops, ref
    sys.path.insert(0, str(ROOT))
    from sabench import corpus
    data = corpus.make_corpus(json.loads(Path(config).read_text()), seed, dev)
    flat, ends = data.data, torch.cumsum(data.lengths, 0)
    n, d = flat.numel(), ends.numel()
    ms = time_ms(lambda: ops.encode_place(flat, ends), dev, reps=20)
    plain_ms = time_ms(lambda: ref.encode_place_ref(flat, ends), dev, reps=2)
    got, want = ops.encode_place(flat, ends), ref.encode_place_ref(flat, ends)
    err = max(require_equal("encode_place text", got[0], want[0]),
              require_equal("encode_place flag", got[1], want[1]))
    stage_s = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        stage_docs(data.docs, dev)
        sync(dev)
        stage_s.append(time.perf_counter() - t0)
    del data, flat, ends, got, want
    empty_cache(dev)
    return {"name": "encode_place", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/encode_place.cu",
            "replaces": None,
            "replaces_note": "no TPU kernel: the JAX package encodes the "
                             "corpus on the host (src/repro/api/index.py, "
                             "encode_docs)",
            "launches": launches.get("encode_place", 0),
            "max_abs_err": err,
            "function": f"the sentinel-separator layout of the infini-gram "
                        f"cell's corpus (seed {seed}): {n} tokens, {d} "
                        f"documents",
            "ms": ms, "plain_ms": plain_ms,
            # each token read and written once, each document's end read
            # and its separator written once (8 bytes each)
            "bound_ms": 1e3 * 16 * (n + d) / bandwidth, "bound_by": "bytes",
            "stage_docs_s": stage_s, "library_ms": None,
            "library_call": "none: no one PyTorch call lays out a corpus"}


def trace_build(dev, label: str, build, top: int = 10) -> dict:
    """Device time by kernel over one call of build() under torch.profiler,
    the device's idle share of its wall time and the host calls with the most
    self time, where `cudaStreamSynchronize` is the host waiting on the
    device (the profiler's own host overhead is inside all of these)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        build()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"build": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "device_kernels": sum(count for _, count in by_name.values()),
            "top": [{"name": name[:90], "ms": ms, "count": count}
                    for name, (ms, count) in ranked],
            "host_top": [{"name": a.key[:60],
                          "self_ms": a.self_cpu_time_total / 1e3,
                          "count": a.count} for a in host[:6]]}


def traces(dev, text) -> None:
    """Phase 7: a "kernel" and a "radix" build and a sparse build of
    `text` under the profiler, one JSON line each."""
    from repro_torch.api import SAOptions, build_suffix_array
    from repro_torch.sparse import build_sparse_suffix_array
    for impl in ("kernel", "radix"):
        log(json.dumps({"trace": trace_build(
            dev, impl, lambda impl=impl: build_suffix_array(
                text, SAOptions(sort_impl=impl), device=dev))}))
    log(json.dumps({"trace": trace_build(
        dev, f"sparse sample_rate={SPARSE_RATE}",
        lambda: build_sparse_suffix_array(text, SPARSE_RATE, device=dev))}))


# --------------------------------------------------------------- phase 8
def counted(dev, path, fn, total: dict):
    """fn() with the launch counts set to 0 just before and read just
    after: on the card exactly the kernels of `path` must have launched
    (none for path None). The counts are added into `total`."""
    from repro_torch.kernels import ops
    zero_launches()
    out = fn()
    sync(dev)
    launches = dict(ops.LAUNCHES)
    if path is None:
        assert not any(launches.values()), launches
    else:
        launched(dev, path, launches)
    for key, n in launches.items():
        total[key] = total.get(key, 0) + n
    return out


def latency_ms(hist: dict) -> dict:
    """p50/p95/p99/mean of a `ServeMetrics` histogram summary, in ms."""
    return {k: None if hist[k] is None else hist[k] * 1e-3
            for k in ("p50", "p95", "p99", "mean")}


def open_loop(dev, index, pats, counts, qps: float, total: dict) -> dict:
    """One open-loop run: `SAServer` over `index` with the reference
    defaults (max_batch 64), warmed over the patterns' length buckets,
    under seeded Poisson arrivals at `qps` cycling through `pats`.
    `counts` are the dense `count_batch` answers; even-numbered patterns
    are planted. The total latency's p50 over the first and the second
    half of the arrivals tells a steady queue from a growing one."""
    import numpy as np
    from repro_torch.api import pow2_bucket
    from repro_torch.serve import (SAServer, make_arrivals, run_open_loop,
                                   summarize)
    lens = sorted({pow2_bucket(len(p), floor=8) for p in pats})
    server = SAServer(index, max_batch=SERVE_BATCH)
    with server:
        t0 = time.perf_counter()
        shapes = counted(dev, None, lambda: server.warmup(pattern_lens=lens),
                         total)
        warm_s = time.perf_counter() - t0
        arrivals = make_arrivals("poisson", qps, len(pats) / qps, seed=SEED)
        t0 = time.perf_counter()
        responses = counted(dev, None, lambda: run_open_loop(
            server, pats, arrivals), total)
        run_s = time.perf_counter() - t0
    statuses = {r.status for r in responses}
    assert statuses <= {"ok", "rejected", "shed"}, statuses
    served = [(i % len(pats), r) for i, r in enumerate(responses) if r.ok]
    assert served, "no request was served"
    got = np.asarray([r.count for _, r in served])
    assert np.array_equal(got, counts[[q for q, _ in served]]), \
        "a served count differs from count_batch"
    assert all(r.count >= 1 for q, r in served if q % 2 == 0), \
        "an admitted planted pattern missed"
    summary = summarize(responses, run_s)
    snap = server.metrics.snapshot()
    half = len(responses) // 2
    halves = [[r.total_us * 1e-3 for r in part if r.ok]
              for part in (responses[:half], responses[half:])]
    return {"arrivals": len(arrivals), "offered_qps": qps,
            "run_s": run_s, "goodput_qps": summary["goodput_qps"],
            "ok": summary["ok"], "rejected": summary["rejected"],
            "shed": summary["shed"], "warmup_shapes": shapes,
            "warmup_s": warm_s,
            "queue_ms": latency_ms(snap["queue_wait_us"]),
            "service_ms": latency_ms(snap["service_us"]),
            "total_ms": latency_ms(snap["total_us"]),
            "total_p50_ms_by_half": [float(np.median(h)) if h else None
                                     for h in halves],
            "batches": snap["batch_size"]["count"],
            "mean_batch": snap["batch_size"]["mean"],
            "mean_occupancy": snap["bucket_occupancy"]["mean"],
            "gc_pauses": snap["counters"]["gc_pauses"]}


def serve_open_loop(dev, index, pats, counts, total: dict,
                    rates=(SERVE_QPS,)) -> dict:
    """Phase 8 (a)/(b): `open_loop` at each offered rate in `rates` (the
    first one's record at the top level, the others under `at_qps`); then
    a closed-loop `QuerySession` over the same patterns, and ten of its
    ticks under `torch.profiler`."""
    import numpy as np
    from repro_torch.api import QuerySession, pow2_bucket
    out = open_loop(dev, index, pats, counts, rates[0], total)
    out["at_qps"] = [open_loop(dev, index, pats, counts, qps, total)
                     for qps in rates[1:]]
    lens = sorted({pow2_bucket(len(p), floor=8) for p in pats})
    session = QuerySession(index, batch_size=SERVE_BATCH)
    session.warmup(pattern_lens=lens)
    closed = counted(dev, None, lambda: session.count(pats), total)
    assert np.array_equal(closed, counts), "QuerySession counts differ"
    closed_summary = session.latency_summary()
    # ten ticks under the profiler: the search's device time and idle share
    traced = trace_build(dev, "10 QuerySession ticks",
                         lambda: session.count(pats[:10 * SERVE_BATCH]),
                         top=5)
    out["closed_loop"] = {"batch_size": SERVE_BATCH,
                          "patterns_per_s": closed_summary["qps"],
                          "tick_p50_ms": closed_summary["p50_us"] * 1e-3,
                          "tick_p99_ms": closed_summary["p99_us"] * 1e-3,
                          "trace": traced}
    return out


def store_round_trip(dev, idx, sp, docs, total: dict, root: str) -> dict:
    """Phase 8 (c): `IndexStore` round trips of the phase-3 corpus, dense
    and sparse: miss (build + save), then hit (load, no build); the
    restored SA equals the built one element for element; a changed
    corpus and a changed plan raise `StaleIndexError`."""
    import torch
    from repro_torch.api import (IndexStore, SAOptions, StaleIndexError,
                                 SuffixArrayIndex, corpus_fingerprint)
    store = IndexStore(root, device=dev)
    text = idx.text.cpu().numpy()
    t0 = time.perf_counter()
    sha = corpus_fingerprint(text)
    out = {"fingerprint_s": time.perf_counter() - t0,
           "text_bytes": text.nbytes}
    for name, opts, path, want in (
            ("dense", SAOptions(), "radix", idx),
            ("sparse", SAOptions(sample_rate=SPARSE_RATE), "sparse", sp)):
        built_s = []

        def build(opts=opts):
            t = time.perf_counter()
            built = SuffixArrayIndex.from_docs(docs, opts, device=dev)
            sync(dev)
            built_s.append(time.perf_counter() - t)
            return built

        t0 = time.perf_counter()
        built, status = counted(dev, path, lambda: store.get_or_build(
            name, build, options=opts, corpus_sha=sha), total)
        miss_s = time.perf_counter() - t0
        assert status == "miss", status
        t0 = time.perf_counter()
        restored, status = counted(dev, None, lambda: store.get_or_build(
            name, build, options=opts, corpus_sha=sha), total)
        load_s = time.perf_counter() - t0
        assert status == "hit" and len(built_s) == 1, status
        assert restored.sa.device == built.sa.device
        assert torch.equal(restored.sa, built.sa), f"{name}: restored SA"
        assert torch.equal(built.sa, want.sa), f"{name}: built SA"
        assert torch.equal(restored.text, idx.text), f"{name}: text"
        out[name] = {"build_s": built_s[0], "save_s": miss_s - built_s[0],
                     "load_s": load_s,
                     "sa_bytes": built.sa.numel() * built.sa.element_size()}
    changed = text.copy()
    changed[len(changed) // 2] ^= 1
    for kw in ({"expect_corpus_sha": corpus_fingerprint(changed)},
               {"options": SAOptions(sort_impl="radix")}):
        try:
            store.load("dense", **kw)
        except StaleIndexError:
            continue
        raise AssertionError(f"a stale entry loaded ({sorted(kw)})")
    out["stats"] = store.stats()
    assert out["stats"] == {"entries": 2, "hits": 2, "misses": 2,
                            "stale": 0}, out["stats"]
    return out


def entry_point(dev, total: dict, root: str, n_docs: int = SERVE_DOCS,
                n_queries: int = SERVE_QUERIES, n_chars=None) -> dict:
    """Phase 8 (d): `serve_sa_queries` at the default `SAConfig`, once
    monolithic with an `IndexStore` (cold, then warm), once with segments,
    ingests and a `SegmentedIndexStore`; then the CLI in a process of its
    own."""
    import numpy as np
    import torch
    from repro_torch.api import SuffixArrayIndex
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_sa_queries
    from repro_torch.trace import counters
    cfg = get_config("suffix-array")
    kw = {"n_chars": n_chars or cfg.n, "n_docs": n_docs,
          "n_queries": n_queries, "device": dev}

    def run_summary(run):
        return {"store": run.store_status, "build_s": run.build_s,
                "n": run.index.n, "ok": run.summary["ok"],
                "rejected": run.summary["rejected"],
                "shed": run.summary["shed"],
                "goodput_qps": run.summary["goodput_qps"],
                "p50_ms": run.summary["p50_ms"],
                "p99_ms": run.summary["p99_ms"],
                "service_ms": latency_ms(run.metrics["service_us"]),
                "mean_batch": run.metrics["batch_size"]["mean"]}

    mono_dir = os.path.join(root, "mono")
    cold = counted(dev, "radix", lambda: serve_sa_queries(
        cfg, store_dir=mono_dir, **kw), total)
    assert cold.store_status == "miss", cold.store_status
    before = counters().get("repro_torch.builds", 0)
    warm = counted(dev, None, lambda: serve_sa_queries(
        cfg, store_dir=mono_dir, **kw), total)
    assert warm.store_status == "hit", warm.store_status
    assert counters().get("repro_torch.builds", 0) == before, \
        "a warm restart built"
    assert torch.equal(warm.index.sa, cold.index.sa)
    seg = counted(dev, "radix", lambda: serve_sa_queries(
        cfg, store_dir=os.path.join(root, "segmented"),
        segments=SERVE_SEGMENTS, ingest=SERVE_INGEST, **kw), total)
    ing = seg.ingest
    assert ing["docs"] == SERVE_INGEST and \
        ing["builds"] == SERVE_INGEST + ing["merges"], ing
    sidx = seg.index
    mono = counted(dev, "radix", lambda: SuffixArrayIndex.from_docs(
        [sidx.doc(i) for i in sidx.doc_ids], cfg.to_options(), sigma=256,
        device=dev), total)
    assert mono.n == sidx.n
    assert np.array_equal(sidx.count_batch(seg.patterns),
                          mono.count_batch(seg.patterns)), \
        "segmented counts differ from the monolithic index's"
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "suffix-array", "--smoke", "--device", str(dev)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert cli.returncode == 0, cli.stdout + cli.stderr
    assert "served" in cli.stdout, cli.stdout
    return {"cold": run_summary(cold), "warm": run_summary(warm),
            "segmented": {**run_summary(seg), "ingest": ing,
                          "segments": sidx.n_segments},
            "cli_s": time.perf_counter() - t0,
            "cli_last_line": cli.stdout.strip().splitlines()[-1]}


def serving(dev, idx, sp, docs, pats, counts) -> dict:
    """Phase 8: (a) dense and (b) sparse open-loop serving, (c) the store,
    (d) the entry point; returns its record and the kernel launches of
    its builds."""
    import numpy as np
    total: dict = {}
    counts = np.asarray(counts)
    out = {"dense": serve_open_loop(dev, idx, pats, counts, total,
                                    rates=(SERVE_QPS, SERVE_STEADY_QPS))}
    log(json.dumps({"serving_dense": out["dense"]}))
    out["sparse"] = serve_open_loop(dev, sp, pats, counts, total)
    log(json.dumps({"serving_sparse": out["sparse"]}))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        out["store"] = store_round_trip(dev, idx, sp, docs, total, root)
        log(json.dumps({"serving_store": out["store"]}))
        out["entry_point"] = entry_point(dev, total, root)
    log(json.dumps({"serving_entry_point": out["entry_point"]}))
    if dev.type == "cuda":
        missing = {k for k in SERVING_KERNELS if not total.get(k)}
        assert not missing, f"phase 8 never launched {sorted(missing)}"
    out["launches"] = total
    return out


# --------------------------------------------------------------- phase 9
def host_kept(docs, g: int):
    """Independent oracle of the gram drop rule, no suffix array: a set of
    every g-gram's bytes seen so far in global order flags a position
    whose gram was seen before; the flags are painted over [p, p + g)."""
    import numpy as np
    seen, out = set(), []
    for d in docs:
        d = np.asarray(d)
        raw = d.astype(np.uint8).tobytes()
        flags = np.zeros(max(len(d) - g + 1, 0), np.int64)
        for p in range(len(flags)):
            key = raw[p:p + g]
            if key in seen:
                flags[p] = 1
            else:
                seen.add(key)
        drop = (np.convolve(flags, np.ones(g, np.int64))[:len(d)] > 0
                if len(flags) else np.zeros(len(d), bool))
        out.append(d[~drop])
    return out


def host_gate(eval_docs, windows, g: int):
    """(hits, contaminated) of `windows` against a host set of every eval
    g-gram: the gate's answer without an index."""
    import numpy as np
    grams = {bytes(e[p:p + g].astype(np.uint8))
             for e in eval_docs for p in range(len(e) - g + 1)}
    hits = np.zeros(len(windows), np.int64)
    mask = np.zeros(windows.shape, bool)
    for w, win in enumerate(windows):
        raw = win.astype(np.uint8).tobytes()
        for p in range(len(win) - g + 1):
            if raw[p:p + g] in grams:
                hits[w] += 1
                mask[w, p:p + g] = True
    return hits, mask


def data_plane_corpus(n_chars: int, n_eval: int):
    """Phase 9's shards (the generator and duplicate rate of
    benchmarks/data_plane_bench.py) and its eval documents, DP_PLANTED of
    them carrying a PASSAGE-char copy of a training document; returns
    (shards, docs, eval_docs, planted (doc, offset) pairs)."""
    import numpy as np
    from repro_torch.data.pipeline import (synthetic_corpus,
                                           synthetic_doc_shards)
    shards = synthetic_doc_shards(n_chars, SIGMA, shard_docs=DP_SHARD_DOCS,
                                  doc_len=DP_DOC_LEN, dup_fraction=DP_DUP,
                                  seed=DP_SEED)
    docs = [d for s in shards for d in s]
    ev = synthetic_corpus(n_eval * DP_DOC_LEN, SIGMA, seed=SEED + 9)
    eval_docs = [ev[i * DP_DOC_LEN:(i + 1) * DP_DOC_LEN].copy()
                 for i in range(n_eval)]
    rng = np.random.default_rng(SEED + 9)
    planted = []
    for e in rng.choice(n_eval, DP_PLANTED, replace=False):
        d = int(rng.integers(len(docs)))
        a, b = (int(v) for v in rng.integers(0, DP_DOC_LEN - PASSAGE, 2))
        eval_docs[e][b:b + PASSAGE] = docs[d][a:a + PASSAGE]
        planted.append((d, a))
    return shards, docs, eval_docs, planted


def stream_shards(dev, plane, shards, total: dict) -> list[dict]:
    """Ingest `shards` into `plane`, one at a time, with each stage's wall
    time read by wrappers around the plane's own calls: the prior-shard
    `_prior_flags` (its `contains_batch` calls apart, the rest is the gram
    `np.unique` and its bookkeeping), the segment builds (each must have
    launched exactly the radix path's kernels), the Kasai LCP, the
    compaction, and what is left of `process_shard` (the within-shard
    flags, the drop mask and the host copy of the segment's text and SA).
    """
    from repro_torch.api import index as index_mod
    from repro_torch.api import segments as seg_mod
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    rec: dict = {}

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(dev)
            rec.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    new_segment = seg_mod.SegmentedIndex._new_segment

    def build(self, *args, **kw):
        zero_launches()
        out = timed("builds", new_segment)(self, *args, **kw)
        launches = dict(ops.LAUNCHES)
        launched(dev, "radix", launches)
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        return out

    contains = seg_mod.SegmentedIndex.contains_batch

    def contains_batch(self, patterns):
        rec.setdefault("fan_out", []).append(self.n_segments)
        return timed("contains", contains)(self, patterns)

    compact = seg_mod.SegmentedIndex.compact

    def compact_counted(self):
        merges = timed("compact", compact)(self)
        rec.setdefault("merges", []).append(merges)
        return merges

    out = []
    with mock.patch.object(seg_mod.SegmentedIndex, "_new_segment", build), \
            mock.patch.object(seg_mod.SegmentedIndex, "contains_batch",
                              contains_batch), \
            mock.patch.object(seg_mod.SegmentedIndex, "compact",
                              compact_counted), \
            mock.patch.object(index_mod, "lcp_kasai",
                              timed("lcp", index_mod.lcp_kasai)), \
            mock.patch.object(pipeline.StreamingDedup, "_prior_flags",
                              timed("prior", pipeline.StreamingDedup
                                    ._prior_flags)), \
            mock.patch.object(pipeline.StreamingDedup, "process_shard",
                              timed("process", pipeline.StreamingDedup
                                    .process_shard)):
        for shard in shards:
            rec.clear()
            t0 = time.perf_counter()
            st = plane.ingest_shard(shard)
            sync(dev)
            wall = time.perf_counter() - t0
            merges = sum(rec.get("merges", [0]))
            assert st.builds == 1 + merges == len(rec["builds"]), \
                (st, rec.get("builds"), merges)
            contains_s = sum(rec.get("contains", []))
            build_s = rec["builds"][0]
            lcp_s = sum(rec.get("lcp", []))
            prior_s = rec["prior"][0]
            out.append({
                "docs": st.docs, "chars": st.chars,
                "dropped_chars": st.dropped_chars,
                "prior_hits": st.prior_hits,
                "within_hits": st.within_hits,
                "unique_grams": st.unique_grams, "builds": st.builds,
                "merges": merges, "wall_s": wall,
                "gram_unique_s": prior_s - contains_s,
                "prior_contains_s": contains_s,
                "contains_calls": len(rec.get("contains", [])),
                "segments_searched": max(rec.get("fan_out", [0])),
                "segment_build_s": build_s, "lcp_s": lcp_s,
                "flags_and_mask_s": rec["process"][0] - prior_s - build_s
                - lcp_s,
                "merge_s": sum(rec.get("compact", [])),
                "merge_builds_s": sum(rec["builds"][1:])})
    return out


def data_plane(dev, n_chars: int = DP_CHARS, n_eval: int = DP_EVAL_DOCS
               ) -> dict:
    """Phase 9: the training data plane on the card; returns its record and
    the kernel launches of its builds."""
    import numpy as np
    from repro_torch.api import SuffixArrayIndex
    from repro_torch.data.pipeline import (MemorizationProbe, PipelineConfig,
                                           TrainingDataPlane)
    from repro_torch.text.dedup import DEDUP_MIN_LEN, dedup_docs
    t_phase = time.perf_counter()
    g = DEDUP_MIN_LEN
    shards, docs, eval_docs, planted = data_plane_corpus(n_chars, n_eval)
    cfg = PipelineConfig(dedup=True, vocab=SIGMA, seq_len=DP_SEQ_LEN,
                         global_batch=DP_BATCH, compact_every=4, seed=SEED)
    assert cfg.dedup_min_len == cfg.gate_min_len == g
    total: dict = {}
    plane = counted(dev, "radix", lambda: TrainingDataPlane(
        cfg, eval_docs=eval_docs, device=dev), total)
    assert plane.gate.index.sa.device == dev and plane.index.device == dev
    n = sum(len(d) for d in docs)
    t0 = time.perf_counter()
    per_shard = stream_shards(dev, plane, shards, total)
    stream_s = time.perf_counter() - t0
    log(f"data plane: {len(shards)} shards, {len(docs)} docs, {n} chars "
        f"streamed in {stream_s:.2f} s; builds "
        f"{[s['builds'] for s in per_shard]}")

    # checks 1 and 2: the stream equals the monolithic pass and the oracle
    t0 = time.perf_counter()
    mono, report = counted(dev, "radix", lambda: dedup_docs(
        docs, g, sigma=SIGMA, device=dev), total)
    mono_s = time.perf_counter() - t0
    assert report.dropped_chars == plane.report.dropped_chars > 0
    t0 = time.perf_counter()
    oracle = host_kept(docs, g)
    oracle_s = time.perf_counter() - t0
    assert len(plane._kept) == len(mono) == len(oracle) == len(docs)
    for i, (a, b, c) in enumerate(zip(plane._kept, mono, oracle)):
        assert np.array_equal(a, b), f"doc {i}: stream != dedup_docs"
        assert np.array_equal(a, c), f"doc {i}: stream != host oracle"

    # check 5: deterministic gated batches; gate hits against a host set
    gate = plane.gate
    checked = gate.stats["checked_windows"]
    t0 = time.perf_counter()
    batches = [plane.batch_at(k) for k in range(DP_STEPS)]
    gate_s = time.perf_counter() - t0
    checked = gate.stats["checked_windows"] - checked
    for k, b in enumerate(batches):
        again = plane.batch_at(k)
        assert sorted(b) == sorted(again) == ["loss_mask", "tokens"]
        assert all(np.array_equal(b[key], again[key]) for key in b), k
        assert b["tokens"].shape == (DP_BATCH, DP_SEQ_LEN + 1)
    rng = np.random.default_rng(SEED + 10)
    win = DP_SEQ_LEN + 1
    starts = []
    for d, a in planted:
        for off in (-400, -100, 150, 400):
            starts.append((d, int(np.clip(a + off, 0, DP_DOC_LEN - win))))
    while len(starts) < DP_WINDOWS:
        starts.append((int(rng.integers(len(docs))),
                       int(rng.integers(0, DP_DOC_LEN - win + 1))))
    windows = np.stack([docs[d][s:s + win] for d, s in starts])
    hits, mask = gate.check(windows)
    want_hits, want_mask = host_gate(eval_docs, windows, g)
    assert np.array_equal(hits, want_hits), "gate hits != host set"
    assert np.array_equal(mask, want_mask), "gate mask != host set"
    assert (hits[:4 * len(planted)] > 0).all(), "a planted window missed"

    # check 6: the probe against a monolithic index of the raw documents
    mono_idx = counted(dev, "radix", lambda: SuffixArrayIndex.from_docs(
        docs, sigma=SIGMA, device=dev), total)
    copies = [k[100:100 + DP_PROBE_LEN + 64] for k in plane._kept
              if len(k) == DP_DOC_LEN][:DP_PROBES // 2]
    assert len(copies) == DP_PROBES // 2, "too few untouched documents"
    samples = copies + [rng.integers(0, SIGMA, DP_PROBE_LEN)
                        for _ in range(DP_PROBES - len(copies))]
    t0 = time.perf_counter()
    probe = plane.probe(samples)
    probe_s = time.perf_counter() - t0
    want = MemorizationProbe(mono_idx, min_len=g).run(samples)
    assert probe == want, (probe, want)
    assert probe["longest_copy_max"] >= DP_PROBE_LEN, probe
    del mono_idx

    # one shard's ingest under the profiler, in a plane of its own
    t0 = time.perf_counter()
    side = TrainingDataPlane(cfg, device=dev)
    for shard in shards[:DP_TRACED_SHARD]:
        side.ingest_shard(shard)
    traced = trace_build(dev, f"ingest of shard {DP_TRACED_SHARD} "
                         f"({side.index.n_segments} prior segments)",
                         lambda: side.ingest_shard(shards[DP_TRACED_SHARD]))
    assert all(np.array_equal(a, b) for a, b in zip(
        side._kept, plane._kept)), "the traced plane's bytes differ"
    del side
    traced["with_setup_s"] = time.perf_counter() - t0
    out = {"card": card_line() if dev.type == "cuda" else "cpu",
           "shards": len(shards), "docs": len(docs), "chars": n,
           "eval_docs": len(eval_docs), "planted": len(planted),
           "stream_s": stream_s, "stream_chars_per_s": n / stream_s,
           "monolithic_s": mono_s, "monolithic_chars_per_s": n / mono_s,
           "host_oracle_s": oracle_s,
           "dropped_chars": plane.report.dropped_chars,
           "builds": plane.report.builds,
           "merges": sum(s["merges"] for s in per_shard),
           "per_shard": per_shard,
           "gate": {"steps": DP_STEPS, "windows_checked": checked,
                    "windows_per_s": checked / gate_s,
                    "stats": plane.gate_stats(),
                    "hits_of_64": int((hits > 0).sum())},
           "probe": {**probe, "ms_per_sample": 1e3 * probe_s / len(samples)},
           "trace": traced, "launches": total,
           "phase_s": time.perf_counter() - t_phase}
    return out


# -------------------------------------------------------------- phase 10
def lm_train(dev) -> tuple[dict, dict]:
    """Phase 10 (a): `launch.train.main` at full width; returns its
    report and what it saw: the trained model, the plane, the plane's
    build time and launches, each step's launches and the run's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    seen: dict = {"steps": []}
    make_step, make_state = train_launch.make_train_step, \
        train_launch.make_train_state
    build = train_launch.build_plane

    def counted_build(args, vocab, *, device):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        plane = build(args, vocab, device=device)
        sync(dev)
        seen["plane_s"] = time.perf_counter() - t0
        seen["plane"] = plane
        seen["plane_launches"] = {k: ops.LAUNCHES[k] - before[k]
                                  for k in before}
        return plane

    def counted_step(cfg, tcfg):
        step = make_step(cfg, tcfg)

        def run(state, batch):
            before = dict(ops.LAUNCHES)
            out = step(state, batch)
            seen["steps"].append({k: ops.LAUNCHES[k] - before[k]
                                  for k in before if ops.LAUNCHES[k]
                                  != before[k]})
            return out
        return run

    def kept_state(params, tcfg):
        seen["model"] = params
        return make_state(params, tcfg)

    zero_launches()
    with mock.patch.object(train_launch, "build_plane", counted_build), \
            mock.patch.object(train_launch, "make_train_step", counted_step), \
            mock.patch.object(train_launch, "make_train_state", kept_state):
        report = train_launch.main(LM_ARGV)
    seen["launches"] = dict(ops.LAUNCHES)
    return report, seen


def lm_decode(dev, model, cfg) -> dict:
    """Phase 10 (c): greedy decode past the window, each step's logits
    held against a full forward of the decoded tokens (the steps see the
    tokens a teacher-forced pass would), one decode step traced; then the
    serving CLI."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import logits_from_embedding
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    serve.prefill_then_decode(model, cfg, prompts[:, :8], 2)  # warm-up
    steps, rings = [], set()
    step = serve.decode_step

    def recorded(params, cfg_, token, states, cur_pos, **kw):
        rings.update(st["t"]["k"].shape[1] for st in states)
        logits, states = step(params, cfg_, token, states, cur_pos, **kw)
        steps.append(logits[:, 0])
        return logits, states

    sync(dev)
    t0 = time.perf_counter()
    with mock.patch.object(serve, "decode_step", recorded):
        toks = serve.prefill_then_decode(model, cfg, prompts, LM_GEN)
    sync(dev)
    decode_s = time.perf_counter() - t0
    T = LM_PROMPT + LM_GEN
    assert toks.shape == (LM_BATCH, T) and len(steps) == T
    assert sorted(rings) == [cfg.window, T], rings      # the local rings wrap
    with torch.no_grad():
        hidden, _, _ = lm.forward_hidden(model, cfg, toks)
        full = logits_from_embedding(hidden, model.embed, cfg.logit_softcap)
        del hidden
        assert bool(torch.isfinite(full).all())
        scale = float(full.abs().max())
        errs = [float((lg - full[:, t]).abs().max()) / scale
                for t, lg in enumerate(steps)]
        del full, steps
        states = lm.init_decode_states(cfg, LM_BATCH, cache_len=T,
                                       device=dev)
        traced = trace_build(dev, "decode step", lambda: lm.decode_step(
            model, cfg, toks[:, :1], states, 0))
        del states
    worst = max(errs)
    assert worst < LM_REL, (errs.index(worst), worst)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LM_CLI],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert cli.returncode == 0, cli.stdout + cli.stderr
    assert f"generated {LM_CLI_TOKENS} tokens" in cli.stdout, cli.stdout
    return {"batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
            "seconds": decode_s, "ms_per_step": 1e3 * decode_s / T,
            "tokens_per_s": LM_BATCH * T / decode_s,
            "generated_tokens_per_s": LM_BATCH * LM_GEN / decode_s,
            "max_rel_err": worst, "worst_position": errs.index(worst),
            "errs_past_window_max": max(errs[cfg.window:]),
            "trace": traced,
            "cli_s": time.perf_counter() - t0,
            "cli": [ln for ln in cli.stdout.splitlines()
                    if ln.startswith("generated")][0]}


def lm_card_against_cpu(dev) -> dict:
    """Phase 10 (d): gemma3-1b at smoke on the card against the CPU path
    with the same params, and the banded attention path at full head
    shapes."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.attention import flash_attention
    from repro_torch.models.layers import logits_from_embedding
    cfg = get_config(LM_ARCH).smoke()
    host = lm.lm_init(cfg, generator=torch.Generator().manual_seed(SEED),
                      device="cpu")
    card = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)))
    mask = torch.from_numpy((rng.random((2, 40)) > 0.3).astype(np.float32))
    out = {}
    with torch.no_grad():
        res = {}
        for name, model, d in (("cpu", host, "cpu"), ("card", card, dev)):
            h, _, _ = lm.forward_hidden(model, cfg, toks[:, :-1].to(d))
            logits = logits_from_embedding(h, model.embed,
                                           cfg.logit_softcap).cpu()
            loss, _ = lm.lm_loss(model, cfg, {"tokens": toks.to(d),
                                              "loss_mask": mask.to(d)})
            res[name] = (logits, float(loss))
    rel = float((res["card"][0] - res["cpu"][0]).abs().max()
                / res["cpu"][0].abs().max())
    out["smoke_logits_rel"] = rel
    out["smoke_loss"] = {k: v[1] for k, v in res.items()}
    assert rel < LM_REL, rel
    assert abs(res["card"][1] - res["cpu"][1]) < LM_LOSS_ABS, res
    full = get_config(LM_ARCH)
    g = torch.Generator().manual_seed(SEED)
    q = torch.randn(1, LM_BANDED_S, full.n_heads, full.hd, generator=g)
    k = torch.randn(1, LM_BANDED_S, full.n_kv_heads, full.hd, generator=g)
    v = torch.randn(1, LM_BANDED_S, full.n_kv_heads, full.hd, generator=g)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    want = flash_attention(q, k, v, window=full.window).float()
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev),
                          window=full.window).float().cpu()
    out["banded_rel"] = float((got - want).abs().max() / want.abs().max())
    assert out["banded_rel"] < LM_REL, out
    return out


def lm_phase(dev) -> dict:
    """Phase 10: (a)-(d) in this process; returns the {"lm": ...} record
    and the phase's kernel launches."""
    import math
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.lm import param_count
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step)
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        sync(dev)               # initialises CUDA when this phase runs first
        torch.cuda.reset_peak_memory_stats(dev)

    # (a) train at full width on the data plane
    t0 = time.perf_counter()
    report, seen = lm_train(dev)
    train_s = time.perf_counter() - t0
    model = seen.pop("model")
    cfg = model.cfg
    n_params = param_count(model)
    launched = {k for k, v in seen["launches"].items() if v}
    if cuda:
        assert launched == PATH_KERNELS["radix"] | STAGE_KERNELS, \
            seen["launches"]
        assert {k for k, v in seen["plane_launches"].items() if v} == \
            PATH_KERNELS["radix"] | STAGE_KERNELS, seen["plane_launches"]
    assert len(seen["steps"]) == 4 and not any(seen["steps"]), seen["steps"]
    assert math.isfinite(report["loss"]) and \
        report["loss"] < math.log(cfg.vocab_size) + 3, report
    masked = [s["masked_frac"] for s in report["steps"]]
    assert max(masked) > 0 and report["gate"]["masked_windows"] > 0, report
    assert report["dedup"]["builds"] == report["dedup"]["shards"] > 1, report
    assert report["probe"]["samples"] > 0, report
    step_s = float(np.median([s["s"] for s in report["steps"][1:4]]))
    tokens = LM_BATCH * LM_SEQ_LEN
    plane = seen.pop("plane")

    # (b) convergence on one fixed batch, a fresh optimizer state
    batch = plane.batch_at(0)
    del plane
    empty_cache(dev)
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=LM_FIT_LR),
                       schedule=cfg.lr_schedule, warmup=1,
                       total_steps=LM_FIT_STEPS)
    state = make_train_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    zero_launches()
    fit = []
    for _ in range(LM_FIT_STEPS):
        state, m = step(state, batch)
        fit.append(float(m["loss"]))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    assert all(map(math.isfinite, fit)) and fit[-1] < fit[0], fit
    held = {"state": state}

    def one_step():
        held["state"], _ = step(held["state"], batch)
    step_trace = trace_build(dev, "train step", one_step)
    del state, step, held
    empty_cache(dev)
    peak_train = torch.cuda.max_memory_allocated(dev) if cuda else None

    # (c) decode against forward past the window, then the serving CLI
    zero_launches()
    decode = lm_decode(dev, model, cfg)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    del model
    empty_cache(dev)

    # (d) the card against the CPU path at smoke
    parity = lm_card_against_cpu(dev)
    return {"card": card_line() if cuda else "cpu", "arch": LM_ARCH,
            "params": n_params,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None),
            "max_memory_allocated_train": peak_train,
            "train": {"argv": LM_ARGV, "seconds": train_s,
                      "step_s_median_2_4": step_s,
                      "step_s": [s["s"] for s in report["steps"]],
                      "tokens_per_step": tokens,
                      "tokens_per_s": tokens / step_s,
                      "tflops": 6 * n_params * tokens / step_s / 1e12,
                      "tflops_formula": "6 * params * tokens_per_s / 1e12 "
                                        "(params include the 302M-entry "
                                        "embedding; attention not counted)",
                      "loss": [s["loss"] for s in report["steps"]],
                      "masked_frac": masked},
            "fit": {"lr": LM_FIT_LR, "losses": fit},
            "train_step_trace": step_trace,
            "data_plane": {"build_s": seen["plane_s"],
                           "dedup": report["dedup"], "gate": report["gate"],
                           "probe": report["probe"],
                           "launches": seen["plane_launches"]},
            "decode": decode, "card_against_cpu": parity,
            "phase_s": time.perf_counter() - t_phase}, seen["launches"]


# -------------------------------------------------------------- phase 11
def moe_routes(record: list):
    """A patch of `ffn.moe_route` that appends each call's (kept, routed)
    token-expert assignment counts to `record` (the kept count stays on
    the device until read)."""
    from repro_torch.models import ffn
    route = ffn.moe_route

    def recorded(logits, cfg):
        rt = route(logits, cfg)
        record.append((rt.ekeep.sum(), rt.ids.numel()))
        return rt
    return mock.patch.object(ffn, "moe_route", recorded)


def drop_share(record: list):
    """The share of routed assignments the capacities dropped."""
    if not record:
        return None
    return 1 - sum(int(k) for k, _ in record) / sum(n for _, n in record)


def decode_against_forward(dev, model, cfg, prompts, gen: int, *,
                           enc_out=None, temperature: float = 0.0):
    """`prefill_then_decode` of `prompts` with each step's logits kept,
    held against one `forward_hidden` of the decoded tokens (the steps
    see the tokens a teacher-forced pass would). Returns its record and
    the tokens."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import logits_from_embedding
    steps = []
    step = serve.decode_step

    def recorded(params, cfg_, token, states, cur_pos, **kw):
        logits, states = step(params, cfg_, token, states, cur_pos, **kw)
        steps.append(logits[:, 0])
        return logits, states

    sync(dev)
    t0 = time.perf_counter()
    with mock.patch.object(serve, "decode_step", recorded):
        toks = serve.prefill_then_decode(model, cfg, prompts, gen,
                                         enc_out=enc_out,
                                         temperature=temperature, seed=SEED)
    sync(dev)
    decode_s = time.perf_counter() - t0
    T = toks.shape[1]
    assert len(steps) == T, (len(steps), T)
    record: list = []
    with torch.no_grad(), moe_routes(record):
        hidden, _, _ = lm.forward_hidden(model, cfg, toks, enc_out=enc_out)
        full = logits_from_embedding(hidden, model.embed, cfg.logit_softcap)
    assert bool(torch.isfinite(full).all())
    scale = float(full.abs().max())
    errs = [float((lg - full[:, t]).abs().max()) / scale
            for t, lg in enumerate(steps)]
    worst = max(errs)
    rec = {"rows": toks.shape[0], "positions": T, "seconds": decode_s,
           "ms_per_step": 1e3 * decode_s / T, "max_rel_err": worst,
           "worst_position": errs.index(worst),
           "forward_dropped_share": drop_share(record)}
    assert worst < LM_REL, (cfg.name, rec)
    return rec, toks


def moe_train(dev) -> tuple[dict, dict]:
    """Phase 11 (a): phi3.5-moe at 2 layers through the trainer's own
    functions on phase 10's plane; returns its record and the run's
    kernel launches."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import lm
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import TrainConfig
    cuda = dev.type == "cuda"
    args = train_launch.parser().parse_args(MOE_ARGV)
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=args.lr),
                       schedule=cfg.lr_schedule,
                       warmup=max(args.steps // 20, 1),
                       total_steps=args.steps)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    plane = train_launch.build_plane(args, vocab=min(cfg.vocab_size, 256),
                                     device=dev)
    sync(dev)
    plane_s = time.perf_counter() - t0
    plane_launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    model = train_launch.lm_init(cfg, seed=0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(model)
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if ".moe.w" in n)
    state = train_launch.make_train_state(model, tcfg)
    step = train_launch.make_train_step(cfg, tcfg)
    steps, probe, routed = [], {}, []
    for i in range(args.steps):
        batch = plane.batch_at(i)
        before = dict(ops.LAUNCHES)
        record: list = []
        t0 = time.perf_counter()
        with moe_routes(record):
            state, m = step(state, batch)
        sync(dev)
        rec = {"s": time.perf_counter() - t0}
        assert ops.LAUNCHES == before, ops.LAUNCHES  # no hand kernel
        rec.update({k: float(m[k]) for k in ("loss", "xent", "aux",
                                             "grad_norm", "masked_frac")})
        rec["dropped_share"] = drop_share(record)
        routed += record
        steps.append(rec)
        if (i + 1) % args.probe_every == 0:
            probe = train_launch.run_probe(plane, model, cfg, args, step=i)
    sync(dev)
    launches = dict(ops.LAUNCHES)
    if cuda:
        assert {k for k, v in launches.items() if v} == \
            PATH_KERNELS["radix"] | STAGE_KERNELS, launches
        assert {k for k, v in plane_launches.items() if v} == \
            PATH_KERNELS["radix"] | STAGE_KERNELS, plane_launches
    losses = [s["loss"] for s in steps]
    assert all(map(math.isfinite, losses)), steps
    assert losses[-1] < math.log(cfg.vocab_size) + 3, steps
    assert max(s["masked_frac"] for s in steps) > 0, steps
    assert plane.report.builds == plane.report.shards > 1
    assert probe.get("samples", 0) > 0, probe
    step_s = float(np.median([s["s"] for s in steps[1:]]))
    tokens = LM_BATCH * LM_SEQ_LEN
    peak_train = torch.cuda.max_memory_allocated(dev) if cuda else None
    gate = plane.gate_stats()
    dedup = {"dropped_chars": plane.report.dropped_chars,
             "shards": plane.report.shards, "builds": plane.report.builds}
    del state, step, plane
    empty_cache(dev)

    # The capacities scale with the tokens of a call (192 in the forward,
    # 4 in a decode step), so where the forward drops an assignment the
    # two differ by design. Decode is held to the forward at a capacity
    # that drops nothing (cap_e >= T at E/k); the same tokens' forward at
    # the config's capacity gives its drop share.
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, MOE_PROMPT))
    zero_launches()
    decode, toks = decode_against_forward(
        dev, model, cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k),
        prompts, MOE_GEN, temperature=1.0)
    assert decode["forward_dropped_share"] == 0, decode
    record = []
    with torch.no_grad(), moe_routes(record):
        lm.forward_hidden(model, cfg, toks)
    decode["forward_dropped_share_at_config"] = drop_share(record)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    del model
    empty_cache(dev)
    return {"arch": MOE_ARCH, "layers": MOE_LAYERS, "params": n_params,
            "expert_params": experts, "init_s": init_s,
            "plane_build_s": plane_s, "plane_launches": plane_launches,
            "dedup": dedup, "gate": gate, "probe": probe,
            "step_s_first": steps[0]["s"],
            "step_s_median_2_4": step_s, "tokens_per_step": tokens,
            "tokens_per_s": tokens / step_s,
            "dropped_share": drop_share(routed),
            "capacity_slots_per_layer": cfg.n_experts * (int(
                cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
                + 8),
            "assignments_per_layer": tokens * cfg.top_k,
            "max_memory_allocated_train": peak_train, "steps": steps,
            "decode": decode}, launches


def kind_runs(dev) -> list[dict]:
    """Phase 11 (b): recurrentgemma-2b, rwkv6-1.6b and whisper-small at
    their published widths: one train step on seeded tokens, then greedy
    decode against the forward; one more rwkv6 step under the profiler
    (its kernel count)."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step)
    cuda = dev.type == "cuda"
    out = []
    for arch, layers, batch, seq in KIND_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        model = lm.lm_init(cfg, seed=0, device=dev)
        tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=1e-4),
                           schedule=cfg.lr_schedule, warmup=1, total_steps=4)
        state = make_train_state(model, tcfg)
        step = make_train_step(cfg, tcfg)
        rng = np.random.default_rng(SEED)
        data = {"tokens": rng.integers(0, cfg.vocab_size,
                                       (batch, seq + 1)).astype(np.int32)}
        enc = None
        if cfg.is_encdec:
            enc = (0.02 * rng.standard_normal(
                (batch, cfg.enc_seq, cfg.d_model))).astype(np.float32)
            data["enc_embeds"] = enc
        zero_launches()
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, data)
        sync(dev)
        step_s = time.perf_counter() - t0
        assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
        # one step from the seeded init: the tied embedding gives a token's
        # own logit about sqrt(d_model) where no post-norm dilutes it (the
        # reference's init gives the same loss), so no bound on its value
        loss = float(m["loss"])
        assert math.isfinite(loss) and math.isfinite(float(m["grad_norm"]))
        traced = None
        if cfg.pattern == ("w",):
            held = {"state": state}

            def one_step():
                held["state"], _ = step(held["state"], data)
            traced = trace_build(dev, f"{arch} train step", one_step)
            del held
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        del state, step
        empty_cache(dev)
        enc_out = None
        if enc is not None:
            with torch.no_grad():
                enc_out = lm.encode(model, cfg, torch.from_numpy(enc).to(dev))
        prompts = rng.integers(0, cfg.vocab_size, (batch, KIND_PROMPT))
        decode, _ = decode_against_forward(dev, model, cfg, prompts,
                                           KIND_GEN, enc_out=enc_out)
        assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
        out.append({"arch": arch, "layers": cfg.n_layers,
                    "encoder_layers": cfg.encoder_layers,
                    "params": lm.param_count(model),
                    "batch": batch, "tokens_per_step": batch * seq,
                    "step_s_first": step_s, "loss": loss,
                    "max_memory_allocated": peak, "train_step_trace": traced,
                    "decode": decode})
        del model, enc_out
        empty_cache(dev)
    return out


def new_kinds_card_against_cpu(dev) -> dict:
    """Phase 11 (c): each new config at smoke on the card against the CPU
    path with the same params (one CPU generator)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.layers import logits_from_embedding
    out = {}
    for arch in NEW_ARCHS:
        cfg = get_config(arch).smoke()
        host = lm.lm_init(cfg, generator=torch.Generator().manual_seed(SEED),
                          device="cpu")
        card = copy.deepcopy(host).to(dev)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(
                     rng.integers(0, cfg.vocab_size, (2, 41))),
                 "loss_mask": torch.from_numpy(
                     (rng.random((2, 40)) > 0.3).astype(np.float32))}
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.from_numpy((0.02 * rng.standard_normal(
                (2, cfg.enc_seq, cfg.d_model))).astype(np.float32))
        res = {}
        with torch.no_grad():
            for name, model, d in (("cpu", host, "cpu"), ("card", card, dev)):
                b = {k: v.to(d) for k, v in batch.items()}
                enc_out = (lm.encode(model, cfg, b["enc_embeds"])
                           if cfg.is_encdec else None)
                h, _, _ = lm.forward_hidden(model, cfg, b["tokens"][:, :-1],
                                            enc_out=enc_out)
                logits = logits_from_embedding(h, model.embed,
                                               cfg.logit_softcap).cpu()
                loss, _ = lm.lm_loss(model, cfg, b)
                res[name] = (logits, float(loss))
        rel = float((res["card"][0] - res["cpu"][0]).abs().max()
                    / res["cpu"][0].abs().max())
        out[arch] = {"logits_rel": rel,
                     "loss": {k: v[1] for k, v in res.items()}}
        assert rel < LM_REL, (arch, rel)
        assert abs(res["card"][1] - res["cpu"][1]) < LM_LOSS_ABS, (arch, res)
    return out


def kinds_phase(dev) -> tuple[dict, dict]:
    """Phase 11: (a)-(c) in this process; returns the {"lm_kinds": ...}
    record and the phase's kernel launches."""
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        sync(dev)               # initialises CUDA when this phase runs first
    moe, launches = moe_train(dev)
    kinds = kind_runs(dev)
    parity = new_kinds_card_against_cpu(dev)
    return {"card": card_line() if cuda else "cpu", "moe": moe,
            "kinds": kinds, "card_against_cpu": parity,
            "phase_s": time.perf_counter() - t_phase}, launches


# -------------------------------------------------------------- phase 12
def stage_clock(record: list):
    """Patches of `repro_torch.bsp.suffix_array`'s stage wrappers (`_sm1`,
    `_sm2`) and of its base case that append each call's host-clock
    seconds (synchronised at both ends) with the level's v and n_loc."""
    from contextlib import ExitStack
    from repro_torch.bsp import suffix_array as bsa
    stack = ExitStack()

    def clocked(name, fn):
        def run(*args, **kw):
            dev = args[0].devices[0] if name != "base" else kw["device"]
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(dev)
            record.append({"stage": name, "v": kw.get("v"),
                           "n_loc": (len(args[0]) if name == "base"
                                     else kw["n_loc"]),
                           "s": time.perf_counter() - t0})
            return out
        return run
    for name, attr in (("SM1", "_sm1"), ("SM2", "_sm2"),
                       ("base", "suffix_array_torch")):
        stack.enter_context(mock.patch.object(
            bsa, attr, clocked(name, getattr(bsa, attr))))
    return stack


def first_local_sort(record: list):
    """A patch of SM1's key-mode local sort that keeps a copy of the rows
    of its first call (rank 0, level 0: the main path's shape)."""
    from repro_torch.bsp import suffix_array as bsa
    sort = bsa.local_sort_lex

    def recorded(rows, key_sort="radix"):
        if not record:
            record.append(rows.clone())
        return sort(rows, key_sort)
    return mock.patch.object(bsa, "local_sort_lex", recorded)


def bsp_local_sort_check(dev, rows) -> dict:
    """The radix kernels on the card at the main path's local-sort shape
    (rank 0's level-0 SM1 rows) against their plain versions, and timed
    beside the plain versions and the `torch.sort` key sort."""
    from repro_torch.bsp import psort
    from repro_torch.core import words
    from repro_torch.kernels import ref
    cols = range(rows.shape[1])
    zero_launches()
    got = psort.argsort_rows(rows, cols, "radix")
    with mock.patch.object(words, "radix_argsort", ref.radix_argsort_ref):
        err = require_equal("bsp level-0 local sort", got,
                            psort.argsort_rows(rows, cols, "radix"))
        plain_ms = time_ms(lambda: psort.argsort_rows(rows, cols, "radix"),
                           dev)
    return {"rows": list(rows.shape), "max_abs_err": err,
            "ms": time_ms(lambda: psort.argsort_rows(rows, cols, "radix"),
                          dev, reps=5),
            "plain_ms": plain_ms,
            "torch_sort_ms": time_ms(
                lambda: psort.argsort_rows(rows, cols, "torch"), dev,
                reps=5)}


def bsp_phase(dev, idx, docs, pats, counts) -> tuple[dict, dict]:
    """Phase 12: Algorithm 3 on a mesh of BSP_P ranks on the card. Returns
    the {"bsp": ...} record and the launches of (a)'s cold build."""
    from contextlib import ExitStack
    import torch
    from repro_torch.api import SAOptions, SuffixArrayIndex, build_suffix_array
    from repro_torch.bsp.counters import BSPCounters
    from repro_torch.bsp.suffix_array import estimate_costs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_sa_mesh
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"

    def build(record=None, sorted_rows=None):
        """One build of `docs` on a fresh mesh; with `record`, each
        stage's host-clock seconds go there; with `sorted_rows`, the rows
        of the first local sort."""
        mesh = make_sa_mesh(BSP_P, device=dev.type)
        ct = BSPCounters()
        opts = SAOptions(mesh=mesh, sort_impl="auto", counters=ct)
        sync(dev)
        t0 = time.perf_counter()
        with ExitStack() as stack:
            if record is not None:
                stack.enter_context(stage_clock(record))
            if sorted_rows is not None:
                stack.enter_context(first_local_sort(sorted_rows))
            out = SuffixArrayIndex.from_docs(docs, opts, device=dev)
        sync(dev)
        return out, ct, mesh, time.perf_counter() - t0

    # (a) the phase-3 corpus through the facade, cold then warm
    cold, warm, rows = [], [], []
    zero_launches()
    bidx, ct, mesh, cold_s = build(cold, rows)
    launches = dict(ops.LAUNCHES)
    launched(dev, "bsp", launches)
    assert torch.equal(bidx.sa, idx.sa), "bsp SA differs from the dense SA"
    got = bidx.count_batch(pats)
    assert (got == counts).all(), "bsp count_batch differs"
    labels = [e["label"] for e in ct.log]
    bases = labels.count("base/gather")
    assert mesh.rendezvous == ct.supersteps - bases, (mesh.rendezvous,
                                                      ct.summary())
    per_round = {st: sum(lb.startswith(st + "/") for lb in labels)
                 / ct.rounds for st in ("SM1", "SM2")}
    assert per_round == {"SM1": 11, "SM2": 9}, per_round
    est = estimate_costs(bidx.n, BSP_P, sigma=SIGMA)
    # the encoded text's own alphabet: the bytes shifted above one
    # separator a document
    est_text = estimate_costs(bidx.n, BSP_P,
                              sigma=int(bidx.text.max()) + 1)
    _, ct_warm, _, warm_s = build(warm)
    assert ct_warm.log == ct.log
    local_sort = bsp_local_sort_check(dev, rows[0])
    del rows
    traced = trace_build(dev, f"bsp radix p={BSP_P}", lambda: build())
    del bidx
    empty_cache(dev)

    # (b) other meshes and impls, (c) the legacy single-device path
    small_docs = make_corpus(BSP_DOCS, BSP_DOC_LEN, SEED)
    small = SuffixArrayIndex.from_docs(small_docs, SAOptions(), device=dev)
    others = []
    for impl, p in BSP_OTHER + (("legacy bitonic", 1),):
        c = BSPCounters()
        opts = (SAOptions(sort_impl="bitonic") if p == 1 else
                SAOptions(mesh=make_sa_mesh(p, device=dev.type),
                          sort_impl=impl, counters=c))
        zero_launches()
        sync(dev)
        t0 = time.perf_counter()
        sa = build_suffix_array(small.text, opts, device=dev)
        sync(dev)
        sec = time.perf_counter() - t0
        assert torch.equal(sa, small.sa), f"{impl} p={p} SA differs"
        if impl == "radix":
            launched(dev, "bsp", dict(ops.LAUNCHES), staged=False)
        others.append({"impl": impl, "p": p, "n": small.n, "build_s": sec,
                       "counters": c.summary() if p > 1 else None,
                       "launches": dict(ops.LAUNCHES)})
    del small
    empty_cache(dev)
    return {"card": card_line() if cuda else "cpu", "p": BSP_P,
            "n": idx.n, "counters": ct.summary(),
            "estimate": est.summary(),
            "estimate_text_sigma": est_text.summary(),
            "rendezvous": mesh.rendezvous,
            "base_gathers": bases,
            "labels_per_round": per_round,
            "build_s": {"cold": cold_s, "warm": warm_s},
            "stages_s": {"cold": cold, "warm": warm},
            "launches": launches, "level0_local_sort": local_sort,
            "trace": traced, "others": others,
            "phase_s": time.perf_counter() - t_phase}, launches


# -------------------------------------------------------------- phase 13
def dry_step(dev, cfg, batch: int, seq_len: int, step_s: float) -> dict:
    """Phase 13 (a) for one train step of `cfg` on ``[batch, seq_len]``
    tokens (the shapes phase 10 or 11 trains, with their optimizer and
    remat): the dry run's count on ``meta`` (trip-count scaled) and its
    one-card argument bytes, each held equal to the same step on the card;
    the achieved TFLOP/s over `step_s` (that phase's untraced step
    seconds); the predicted peak beside the measured one; the FLOP split
    by part."""
    import torch
    from repro_torch.launch import dryrun, op_stats
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import TrainConfig
    cuda = dev.type == "cuda"
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer),
                       schedule=cfg.lr_schedule, warmup=1, total_steps=4)
    shape = ShapeConfig("phase", seq_len, batch, "train")
    t0 = time.perf_counter()
    meta = op_stats.scaled_count(lambda c, S: dryrun.train_step_args(
        c, tcfg, batch, S), cfg, seq_len)
    meta_s = time.perf_counter() - t0
    # one card: a mesh of one device a axis
    _, _, specs = dryrun.step_cell(cfg, shape, {"data": 1, "model": 1})
    predicted = {k: dryrun.tree_nbytes(specs[k]) for k in ("params", "opt")}
    split = dryrun.flop_split(cfg, batch, seq_len)

    step, (state, data) = dryrun.train_step_args(cfg, tcfg, batch, seq_len,
                                                 device=dev, seed=SEED)
    measured = dryrun.state_nbytes(state)
    assert measured == predicted, (cfg.name, measured, predicted)
    batch_bytes = sum(t.numel() * t.element_size() for t in data.values())
    sync(dev)
    t0 = time.perf_counter()
    card = op_stats.count(step, state, data)
    sync(dev)
    card_s = time.perf_counter() - t0
    assert card["flops"] == meta["flops"], (cfg.name, card, meta)
    empty_cache(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else None
    state, _ = step(state, data)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del state, data, step
    empty_cache(dev)
    args = sum(measured.values()) + batch_bytes
    predicted_peak = args + meta["peak_bytes"]
    model_flops = dryrun.model_flops_estimate(cfg, shape)
    total = sum(split.values())
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
            "seq_len": seq_len, "remat": cfg.remat,
            "optimizer": cfg.optimizer,
            "flops": meta["flops"], "flops_card": card["flops"],
            "bytes": meta["bytes"], "bytes_card": card["bytes"],
            "model_flops": model_flops,
            "flops_over_model_flops": meta["flops"] / model_flops,
            "step_s": step_s, "tflops": meta["flops"] / step_s / 1e12,
            "argument_bytes": measured, "batch_bytes": batch_bytes,
            "allocated_before_step": before,
            "temp_size_in_bytes": meta["peak_bytes"],
            "predicted_peak": predicted_peak,
            "max_memory_allocated": peak,
            "predicted_over_measured_peak": (predicted_peak / peak
                                             if peak else None),
            "split": split,
            "split_share": {k: v / total for k, v in split.items()},
            "split_sums_to_count": total == meta["flops"],
            "count_s_meta": meta_s, "count_s_card": card_s,
            "runs": meta["runs"]}


def dry_run_phase(dev, lm_step_s: float, moe_step_s: float) -> dict:
    """Phase 13: (a) phase 10's gemma3-1b step and phase 11's phi3.5-moe
    step dry-run and held to the card; (b) one `run_cell` of every arch at
    decode_32k and of gemma3-1b at train_4k, each "ok". Launches no hand
    kernel."""
    from repro_torch.configs import get_config, model_archs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    zero_launches()
    steps = [dry_step(dev, get_config(LM_ARCH), LM_BATCH, LM_SEQ_LEN,
                      lm_step_s),
             dry_step(dev, get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS),
                      LM_BATCH, LM_SEQ_LEN, moe_step_s)]
    cells = []
    for arch, shape in [(a, DRY_SHAPE) for a in model_archs()] + \
            [DRY_TRAIN_CELL]:
        rec = dryrun.run_cell(arch, shape, "single", "")
        assert rec["status"] == "ok", rec
        cells.append({k: rec[k] for k in (
            "arch", "shape", "total_s", "flops", "model_flops",
            "argument_size_in_bytes", "temp_size_in_bytes")})
    launches = dict(ops.LAUNCHES)
    assert not any(launches.values()), launches
    return {"card": card_line() if dev.type == "cuda" else "cpu",
            "steps": steps, "cells": cells, "launches": launches,
            "phase_s": time.perf_counter() - t_phase}


# -------------------------------------------------------------- phase 14
def reference_layout(model) -> list:
    """(path, shape, dtype) of the JAX package's train state of `model`
    with Adafactor, in its flatten order, spelled from
    `convert.param_groups` and Adafactor's factoring rule on ``meta``
    tensors (no copy of the state, no jax)."""
    import torch
    from repro_torch.ckpt.checkpoint import _flatten, _path_str, dtype_name
    from repro_torch.models.convert import param_groups
    params = dict(model.named_parameters())
    meta = torch.device("meta")
    tree: dict = {}

    def put(root, name, leaf):
        *path, last = name.split(".")
        for key in path:
            root = root.setdefault(key, {})
        root[last] = leaf

    for ref, (names, stacked) in param_groups(model).items():
        p = params[names[0]]
        shape = ((len(names),) if stacked else ()) + tuple(p.shape)
        put(tree, f"params.{ref}", torch.empty(shape, dtype=p.dtype,
                                               device=meta))
        f = ({"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
             if len(shape) >= 2 else {"v": shape})
        for k, sh in f.items():
            put(tree, f"opt.f.{ref}.{k}", torch.empty(sh, device=meta))
    tree["opt"]["step"] = torch.empty((), dtype=torch.int32, device=meta)
    return [[_path_str(path), list(t.shape), dtype_name(t.dtype)]
            for path, t in _flatten(tree)]


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def adafactor_resume(dev) -> tuple[dict, dict]:
    """Phase 14 (a): gemma3-1b at its published widths with Adafactor on
    phase 10's plane, through the trainer's own functions: TS_STEPS steps
    straight, a checkpoint in the reference layout after TS_SAVE_AT, the
    checkpoint restored into a state of another seed and its last steps
    run again; returns its record and the plane's launches."""
    import math
    import numpy as np
    import torch
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.train_step import TrainConfig
    cuda = dev.type == "cuda"
    args = train_launch.parser().parse_args(LM_ARGV)
    cfg = get_config(LM_ARCH)
    tcfg = TrainConfig(opt=OptConfig(name="adafactor", lr=args.lr),
                       schedule=cfg.lr_schedule,
                       warmup=max(TS_STEPS // 20, 1), total_steps=TS_STEPS)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    plane = train_launch.build_plane(args, vocab=min(cfg.vocab_size, 256),
                                     device=dev)
    sync(dev)
    plane_s = time.perf_counter() - t0
    plane_launches = dict(ops.LAUNCHES)
    batches = [plane.batch_at(i) for i in range(TS_STEPS)]
    del plane
    model = train_launch.lm_init(cfg, seed=SEED, device=dev)
    n_params = lm.param_count(model)
    state = train_launch.make_train_state(model, tcfg)
    step = train_launch.make_train_step(cfg, tcfg)
    straight, step_s = [], []
    with tempfile.TemporaryDirectory(prefix="train_state_") as root:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            straight.append(float(m["loss"]))
            if i + 1 == TS_SAVE_AT:
                t0 = time.perf_counter()
                save_checkpoint(root, TS_SAVE_AT,
                                train_launch.state_tree(state))
                save_s = time.perf_counter() - t0
        assert ops.LAUNCHES == plane_launches, ops.LAUNCHES  # steps: none
        peak_train = torch.cuda.max_memory_allocated(dev) if cuda else None
        want_layout = reference_layout(model)
        del state, step, model, m
        empty_cache(dev)
        with open(os.path.join(root, f"step_{TS_SAVE_AT:08d}",
                               "manifest.json")) as f:
            manifest = json.load(f)
        layout = [list(x) for x in zip(manifest["paths"],
                                       manifest["shapes"],
                                       manifest["dtypes"])]
        assert layout == want_layout, "manifest differs from the layout"
        n_full = cfg.n_layers // len(cfg.pattern)
        blocks = [x for x in layout if "DictKey(key='blocks')" in x[0]
                  and "DictKey(key='params')" in x[0]]
        assert blocks and all(x[1][0] == n_full for x in blocks), blocks
        tails = {x[0].split("DictKey(key='tail'), ")[1].split(",")[0]
                 for x in layout if "DictKey(key='tail')" in x[0]}
        assert tails == {"DictKey(key='l0')", "DictKey(key='l1')"}, tails
        f_leaves = [x for x in layout if "DictKey(key='f')" in x[0]]
        ckpt_bytes = dir_bytes(root)

        # resume: a state of another seed, the checkpoint restored into it
        fresh = train_launch.make_train_state(
            train_launch.lm_init(cfg, seed=SEED + 1, device=dev), tcfg)
        sync(dev)
        t0 = time.perf_counter()
        tree, _ = restore_checkpoint(root, TS_SAVE_AT,
                                     train_launch.state_tree(fresh))
        fresh = train_launch.load_state_tree(fresh, tree)
        sync(dev)
        restore_s = time.perf_counter() - t0
        del tree
    assert int(fresh["opt"]["step"]) == TS_SAVE_AT

    # steps 3-4 again, each stacked group's update timed (synchronised)
    update_s: list = []
    _, update = ts.make_optimizer(tcfg.opt)

    def timed_update(*a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = update(*a, **kw)
        sync(dev)
        update_s[-1] += time.perf_counter() - t0
        return out

    with mock.patch.object(ts, "make_optimizer",
                           lambda opt: (None, timed_update)):
        step = ts.make_train_step(cfg, tcfg)
    resumed = []
    for batch in batches[TS_SAVE_AT:]:
        update_s.append(0.0)
        fresh, m = step(fresh, batch)
        resumed.append(float(m["loss"]))
    assert ops.LAUNCHES == plane_launches, ops.LAUNCHES
    for got, want in zip(resumed, straight[TS_SAVE_AT:]):
        assert abs(got - want) < LM_LOSS_ABS, (resumed, straight)
    assert all(map(math.isfinite, straight)), straight
    del fresh, step, m, batches
    empty_cache(dev)
    return {"arch": LM_ARCH, "params": n_params, "optimizer": "adafactor",
            "tokens_per_step": LM_BATCH * LM_SEQ_LEN,
            "plane_build_s": plane_s, "plane_launches": plane_launches,
            "loss_straight": straight, "loss_resumed": resumed,
            "step_s": step_s,
            "step_s_median_2_4": float(np.median(step_s[1:])),
            "update_s_resumed": update_s, "save_s": save_s,
            "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
            "leaves": len(layout), "adafactor_leaves": len(f_leaves),
            "stacked_leaves": len(blocks),
            "max_memory_allocated_train": peak_train}, plane_launches


def adafactor_card_against_cpu(dev) -> dict:
    """Phase 14 (b): kimi-k2 at smoke (bf16 embedding, stacked ``[2, ...]``
    leaves) from the same params on the card and the CPU: each loss within
    LM_LOSS_ABS, every Adafactor leaf within LM_REL of its largest
    magnitude; a checkpoint written on the card restores on the CPU with
    every parameter's bits equal."""
    import copy
    import numpy as np
    import torch
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train.optim import OptConfig, tree_leaves
    from repro_torch.train.train_step import (TrainConfig, load_state_tree,
                                              make_train_state,
                                              make_train_step, state_tree)
    cfg = get_config(TS_SMOKE_ARCH).smoke()
    host = lm.lm_init(cfg, generator=torch.Generator().manual_seed(SEED),
                      device="cpu")
    card = copy.deepcopy(host).to(dev)
    tcfg = TrainConfig(opt=OptConfig(name="adafactor", lr=1e-3), warmup=0,
                       total_steps=TS_SMOKE_STEPS + 1)
    rng = np.random.default_rng(SEED)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 41))}
               for _ in range(TS_SMOKE_STEPS)]
    states, losses = {}, {}
    for name, model in (("cpu", host), ("card", card)):
        state, step = make_train_state(model, tcfg), make_train_step(cfg,
                                                                     tcfg)
        losses[name] = []
        for batch in batches:
            state, m = step(state, batch)
            losses[name].append(float(m["loss"]))
        states[name] = state
    for got, want in zip(losses["card"], losses["cpu"]):
        assert abs(got - want) < LM_LOSS_ABS, losses
    rel = 0.0
    for got, want in zip(tree_leaves(states["card"]["opt"]["f"]),
                         tree_leaves(states["cpu"]["opt"]["f"])):
        assert got.shape == want.shape and got.device == card.device
        rel = max(rel, float((got.cpu() - want).abs().max()
                             / want.abs().max()))
    assert rel < LM_REL, rel
    with tempfile.TemporaryDirectory(prefix="train_state_") as root:
        save_checkpoint(root, TS_SMOKE_STEPS, state_tree(states["card"]))
        fresh = make_train_state(lm.lm_init(cfg, seed=SEED + 1,
                                            device="cpu"), tcfg)
        tree, _ = restore_checkpoint(root, TS_SMOKE_STEPS, state_tree(fresh))
        load_state_tree(fresh, tree)
    bits_equal = all(p.cpu().equal(q) for p, q in zip(
        card.parameters(), fresh["params"].parameters()))
    assert bits_equal and fresh["params"].embed.dtype == torch.bfloat16
    return {"arch": TS_SMOKE_ARCH, "widths": "smoke", "loss": losses,
            "adafactor_max_rel": rel, "tolerance": LM_REL,
            "checkpoint_bits_equal_on_cpu": bits_equal}


def train_state_phase(dev) -> tuple[dict, dict]:
    """Phase 14: (a) and (b) in this process; returns the
    {"train_state": ...} record and the phase's kernel launches."""
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        sync(dev)               # initialises CUDA when this phase runs first
    resume, launches = adafactor_resume(dev)
    if cuda:
        assert {k for k, v in launches.items() if v} == \
            PATH_KERNELS["radix"] | STAGE_KERNELS, launches
    parity = adafactor_card_against_cpu(dev)
    return {"card": card_line() if cuda else "cpu", "resume": resume,
            "card_against_cpu": parity,
            "phase_s": time.perf_counter() - t_phase}, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"kernels built: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    kernels_against_plain(dev)
    log(f"kernels against plain: all equal ({time.perf_counter() - t0:.1f} s)")

    docs = make_corpus(N_DOCS, DOC_LEN, SEED)
    idx, launches, builds = main_path(dev, docs)
    rates, pats, counts, located = queries(dev, idx, docs, N_PATTERNS)
    sparse, sp = sparse_path(dev, idx, docs, pats, counts, located)
    bandwidth = dram_bytes_per_s(torch.cuda.get_device_name(0))
    levels = window_levels(dev, idx.text)
    table = kernel_times(dev, levels, launches, bandwidth)
    table.append(dense_rank_gather_times(
        dev, default_build_ranks(dev, idx.text), launches, bandwidth))
    table.append(lemma1_merge_times(dev, launches, bandwidth))
    table.append(encode_place_times(dev, launches, bandwidth))
    for entry in table:
        if entry["name"] in PATH_KERNELS["sparse"] | STAGE_KERNELS:
            entry["launches_sparse"] = sparse["launches"][entry["name"]]
    per_level = bitonic_levels(dev, levels, bandwidth)
    del levels
    log(json.dumps({"builds_s": builds, "queries": rates, "sparse": sparse,
                    "bitonic_levels": per_level}))
    traces(dev, idx.text)
    served = serving(dev, idx, sp, docs, pats, counts)
    plane = data_plane(dev)
    log(json.dumps({"data_plane": plane}))
    del sp, located
    empty_cache(dev)
    bsp, bsp_launches = bsp_phase(dev, idx, docs, pats, counts)
    log(json.dumps({"bsp": bsp}))
    del idx, pats, counts
    empty_cache(dev)
    lm, lm_launches = lm_phase(dev)
    log(json.dumps({"lm": lm}))
    empty_cache(dev)
    kinds, kinds_launches = kinds_phase(dev)
    log(json.dumps({"lm_kinds": kinds}))
    empty_cache(dev)
    dry = dry_run_phase(dev, lm["train"]["step_s_median_2_4"],
                        kinds["moe"]["step_s_median_2_4"])
    log(json.dumps({"dry_run": dry}))
    empty_cache(dev)
    train_state, ts_launches = train_state_phase(dev)
    log(json.dumps({"train_state": train_state}))
    for entry in table:
        names = ("bitonic_tile", "bitonic_cross") \
            if entry["name"] == "bitonic_sort" else \
            ("radix_scatter",) if entry["name"] == "radix_argsort" else \
            (entry["name"],)
        entry["launches_serving"] = sum(served["launches"].get(k, 0)
                                        for k in names)
        entry["launches_data_plane"] = sum(plane["launches"].get(k, 0)
                                           for k in names)
        entry["launches_lm"] = sum(lm_launches.get(k, 0) for k in names)
        entry["launches_moe"] = sum(kinds_launches.get(k, 0) for k in names)
        entry["launches_bsp"] = sum(bsp_launches.get(k, 0) for k in names)
        entry["launches_dryrun"] = sum(dry["launches"].get(k, 0)
                                       for k in names)
        entry["launches_train_state"] = sum(ts_launches.get(k, 0)
                                            for k in names)
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
