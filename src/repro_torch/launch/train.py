"""Training launcher over the SA-backed data plane, on the card.

    python -m repro_torch.launch.train --arch minicpm-2b --smoke --steps 50
    python -m repro_torch.launch.train --arch gemma3-1b --smoke --steps 200 \\
        --ckpt-dir build/ckpt --resume
    python -m repro_torch.launch.train --arch minicpm-2b --smoke --steps 20 \\
        --dedup --shard-docs 8 --eval-gate --plant-contamination 40 \\
        --probe-every 10

The port of `repro.launch.train`. --smoke runs the reduced same-family
config; without it the full config is used. `--device` (default cuda)
picks the card; the run raises without one unless given ``--device cpu``.
Checkpoints every --ckpt-every steps with an async writer, in the JAX
package's train-state layout; --resume continues from the latest
committed step under --ckpt-dir, written by this launcher or by
`repro.launch.train` (its leaves come back onto the device), with
deterministic data skip-ahead: the batches are that package's.

Data goes through `repro_torch.data.pipeline.TrainingDataPlane`, every
index on the same device: the synthetic corpus arrives as document shards
(--shard-docs per shard), each ingested into the streaming dedup index
(--dedup); --eval-gate builds a held-out eval set and rejects/masks
training windows that overlap it (--plant-contamination splices eval text
into the training shards so the gate has real work); --probe-every
decodes samples from the live model and logs longest-verbatim-copy
metrics against the training index into the step report. `main` returns
a metrics dict::

    {"loss": float, "gate": {...}, "probe": {...}, "dedup": {...},
     "steps": [{"loss", "lr", "grad_norm", ["masked_frac"], "s"}, ...]}

``steps`` (one entry per step run, ``s`` its wall seconds up to a device
synchronisation) is the port's addition.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ckpt.checkpoint import (latest_step, restore_checkpoint,
                               save_checkpoint, wait_for_async)
from ..configs import get_config
from ..core.compat import resolve_device
from ..data.pipeline import (GATE_POLICIES, PipelineConfig,
                             TrainingDataPlane, synthetic_corpus,
                             synthetic_doc_shards)
from ..models.lm import lm_init
from ..train.optim import OptConfig
from ..train.train_step import (TrainConfig, load_state_tree,
                                make_train_state, make_train_step,
                                state_tree)


def plant_contamination(shards, eval_docs, *, n_blocks: int,
                        block_len: int, seed: int = 123) -> int:
    """Splice ``n_blocks`` stretches of eval text into the training shards
    (in place) so the contamination gate has guaranteed positives. Blocks
    cycle through distinct eval offsets so dedup can't collapse them.
    Returns the number of chars planted."""
    rng = np.random.default_rng(seed)
    flat = np.concatenate([np.asarray(d).ravel() for d in eval_docs])
    docs = [d for s in shards for d in s if len(d) >= block_len]
    planted = 0
    for k in range(n_blocks):
        src = (k * block_len) % max(len(flat) - block_len, 1)
        doc = docs[int(rng.integers(0, len(docs)))]
        dst = int(rng.integers(0, len(doc) - block_len + 1))
        doc[dst:dst + block_len] = flat[src:src + block_len]
        planted += block_len
    return planted


def build_plane(args, vocab: int, *, device="cuda") -> TrainingDataPlane:
    """Wire the data plane from CLI flags: shards, eval set, gate, probe."""
    pcfg = PipelineConfig(
        seq_len=args.seq_len, global_batch=args.batch, dedup=args.dedup,
        dedup_min_len=args.dedup_min_len, vocab=vocab,
        gate_min_len=args.gate_min_len, gate_policy=args.gate_policy,
        build_index=True if args.probe_every else None)
    shards = synthetic_doc_shards(
        args.corpus_chars, vocab, shard_docs=args.shard_docs,
        doc_len=args.doc_len,
        dup_fraction=0.2 if args.dedup else 0.0)
    eval_docs = None
    if args.eval_gate:
        eval_docs = [synthetic_corpus(4096, vocab, seed=777 + j)
                     for j in range(4)]
        if args.plant_contamination:
            planted = plant_contamination(
                shards, eval_docs, n_blocks=args.plant_contamination,
                block_len=2 * (args.seq_len + 1))
            print(f"gate: planted {planted} contaminated chars "
                  f"({args.plant_contamination} blocks)")
    return TrainingDataPlane(pcfg, eval_docs=eval_docs, shards=shards,
                             device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parser() -> argparse.ArgumentParser:
    """The launcher's command line (`main` parses it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--corpus-chars", type=int, default=200_000)
    ap.add_argument("--log-every", type=int, default=10)
    # ---- data plane ----
    ap.add_argument("--dedup", action="store_true",
                    help="streaming suffix-array dedup over the shards")
    ap.add_argument("--dedup-min-len", type=int, default=48)
    ap.add_argument("--shard-docs", type=int, default=8,
                    help="documents per ingested shard")
    ap.add_argument("--doc-len", type=int, default=4096)
    ap.add_argument("--eval-gate", action="store_true",
                    help="held-out eval set + train/eval contamination gate")
    ap.add_argument("--gate-min-len", type=int, default=48)
    ap.add_argument("--gate-policy", choices=GATE_POLICIES,
                    default="reject")
    ap.add_argument("--plant-contamination", type=int, default=0,
                    help="splice N blocks of eval text into the training "
                         "shards (gives the gate guaranteed positives)")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="every N steps, decode samples and log "
                         "longest-verbatim-copy vs the training index")
    ap.add_argument("--probe-samples", type=int, default=4)
    ap.add_argument("--probe-len", type=int, default=64)
    ap.add_argument("--probe-prompt", type=int, default=16)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tcfg = TrainConfig(
        opt=OptConfig(name=cfg.optimizer, lr=args.lr),
        schedule=cfg.lr_schedule, warmup=max(args.steps // 20, 1),
        total_steps=args.steps, microbatches=args.microbatches)

    plane = build_plane(args, vocab=min(cfg.vocab_size, 256), device=dev)
    if args.dedup:
        rep = plane.report
        print(f"dedup: removed {rep.dup_chars} duplicate chars "
              f"({100 * rep.dup_fraction:.1f}%) across {rep.shards} shards "
              f"({rep.builds} segment builds)")

    params = lm_init(cfg, seed=0, device=dev)
    state = make_train_state(params, tcfg)
    start = 0
    if args.resume and args.ckpt_dir:
        st = latest_step(args.ckpt_dir)
        if st is not None:
            tree, _ = restore_checkpoint(args.ckpt_dir, st, state_tree(state))
            state = load_state_tree(state, tree)
            start = st
            print(f"resumed from step {st}")

    step_fn = make_train_step(cfg, tcfg)
    probe_metrics: dict = {}
    steps: list[dict] = []
    pending = None
    m = None
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        batch = plane.batch_at(i)
        if cfg.is_encdec:
            rng = np.random.default_rng(i)
            batch["enc_embeds"] = 0.02 * rng.standard_normal(
                (args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if args.microbatches > 1:
            B = args.batch // args.microbatches
            batch = {k: v.reshape((args.microbatches, B) + v.shape[1:])
                     for k, v in batch.items()}
        state, m = step_fn(state, batch)
        _sync(dev)
        rec = {k: float(m[k]) for k in ("loss", "lr", "grad_norm",
                                        "masked_frac") if k in m}
        rec["s"] = time.perf_counter() - t_step
        steps.append(rec)
        if args.probe_every and (i + 1) % args.probe_every == 0:
            probe_metrics = run_probe(plane, state["params"], cfg, args,
                                      step=i)
        if (i + 1) % args.log_every == 0 or i == start:
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            line = (f"step {i+1:5d} loss {rec['loss']:.4f} "
                    f"lr {rec['lr']:.2e} "
                    f"gnorm {rec['grad_norm']:.2f}")
            if "masked_frac" in rec:
                line += f" masked {100 * rec['masked_frac']:.2f}%"
            if plane.gate is not None:
                gs = plane.gate.stats
                line += (f" gate[rej {gs['rejected_windows']}"
                         f"/msk {gs['masked_windows']}]")
            if probe_metrics:
                line += (f" copy[max {probe_metrics['longest_copy_max']}"
                         f"/mem {100 * probe_metrics['frac_memorized']:.0f}%]")
            print(line + f" ({dt:.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            wait_for_async(pending)
            pending = save_checkpoint(args.ckpt_dir, i + 1, state_tree(state),
                                      extras={"loss": rec["loss"]},
                                      async_write=True)
    wait_for_async(pending)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state_tree(state))
    report = {"loss": float(m["loss"]) if m is not None else float("nan"),
              "gate": plane.gate_stats(),
              "probe": probe_metrics,
              "dedup": ({"dropped_chars": plane.report.dropped_chars,
                         "dup_fraction": plane.report.dup_fraction,
                         "shards": plane.report.shards,
                         "builds": plane.report.builds}
                        if args.dedup else {})}
    print("done: " + json.dumps(report))
    report["steps"] = steps
    return report


def run_probe(plane: TrainingDataPlane, params, cfg, args, *,
              step: int) -> dict:
    """Decode --probe-samples continuations from corpus prompts and score
    them against the training index (memorization probe); none for an
    encoder-decoder config, as in the JAX package."""
    if cfg.is_encdec or plane.index is None:
        return {}
    from .serve import prefill_then_decode
    corpus, P = plane.corpus, args.probe_prompt
    rng = np.random.default_rng(np.random.SeedSequence([plane.cfg.seed,
                                                        step, 7]))
    starts = rng.integers(0, max(len(corpus) - P, 1),
                          size=args.probe_samples)
    prompts = np.stack([corpus[s:s + P] for s in starts]).astype(np.int32)
    toks = prefill_then_decode(params, cfg, prompts, args.probe_len)
    return plane.probe(list(toks.cpu().numpy()),
                       min_len=plane.cfg.probe_min_len)


if __name__ == "__main__":
    main()
