"""Dry run: every (architecture × input shape) cell's step, counted on the
``meta`` device with nothing allocated, and laid out on the production
meshes by the sharding rules.

The port of `repro.launch.dryrun`. The JAX package lowers and compiles
each cell on the 256- and 512-chip production meshes and records XLA's
memory analysis, its cost analysis and `hlo_stats`' loop-corrected
counts. Here a cell's step runs on ``meta`` under
`repro_torch.launch.op_stats` (trip-count scaled, so rwkv6's 32k-token
prefill and kimi-k2's 61 layers take seconds), once per cell and reused
for both meshes, and the arguments are laid out by
`repro_torch.models.sharding` over the meshes' axis sizes.

A record keeps the JAX package's field names where they mean something
here: ``flops`` and ``flops_corrected`` (the counted dot and convolution
FLOPs, equal here: nothing is counted once), ``bytes`` and
``bytes_corrected`` (eager op bytes), ``model_flops``, and per device
``argument_size_in_bytes``, ``output_size_in_bytes`` (what the step
returns beside its arguments) and ``alias_size_in_bytes`` (what it
returns by updating its arguments in place: the train state, the decode
KV caches). ``temp_size_in_bytes`` is the predicted peak of the step's
working set above its arguments on one device that runs the whole step
(`op_stats`' ``peak_bytes``); ``argument_size_in_bytes_one_card`` the
arguments of that device, by part. The JAX package's ``lower_s``,
``compile_s``, ``generated_code_size_in_bytes``, ``hlo_lines`` and
collective fields have no counterpart: there is no HLO, and the step
runs no collective on one card.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import get_config, model_archs
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.attention import attention_layer
from ..models.ffn import mlp_layer, moe_layer
from ..models.layers import (COMPUTE_DTYPE, chunked_softmax_xent,
                             logits_from_embedding)
from ..models.lm import (_cross_kv, _run_blocks, decode_step, encode,
                         forward_hidden, lm_init)
from ..models.rglru import rglru_layer
from ..models.rwkv6 import rwkv_channel_mix, rwkv_time_mix
from ..models.sharding import ShardingRules, filter_spec
from ..train.train_step import make_train_state, make_train_step
from .mesh import mesh_num_devices, production_mesh_shape
from .op_stats import count, scaled_count
from .specs import (META, abstract_params, abstract_train_state, cell_runs,
                    decode_batch_specs, decode_state_specs,
                    default_train_config, dp_axes, params_shardings,
                    prefill_specs, spec_of, train_batch_specs,
                    train_state_shardings, walk)


def model_params_breakdown(cfg: ModelConfig):
    """(n_total, n_active, n_embed) from the abstract params. MoE expert
    params are counted at top_k/E for n_active."""
    total = active = emb = 0
    for name, p in abstract_params(cfg).named_parameters():
        n = p.numel()
        total += n
        if name == "embed":
            emb += n
        elif ".moe." in name and not name.endswith(".moe.router"):
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        else:
            active += n
    return total, active, emb


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (prefill/decode);
    N excludes the embedding table (the counted/model ratio captures
    attention-score and lm-head compute)."""
    _, n_active, _ = model_params_breakdown(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # one token per sequence


def _tensors(specs):
    if isinstance(specs, dict):
        return {k: _tensors(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_tensors(v) for v in specs]
    return specs.tensor


def step_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict,
              rules: ShardingRules | None = None):
    """(fn, args, specs) of a cell's step on ``meta``: ``fn(*args)`` runs
    it; ``specs`` holds each argument's `Spec` by part ("params", "opt",
    "batch", "states") and the outputs' ("out", returned beside the
    arguments; "alias", returned by updating them in place)."""
    dp = dp_axes(mesh_shape)
    B = shape.global_batch
    if shape.kind == "train":
        tcfg = default_train_config(cfg)
        state = abstract_train_state(cfg, tcfg)
        st = train_state_shardings(tcfg, state, mesh_shape, rules)
        batch = train_batch_specs(cfg, shape, mesh_shape)
        # the step updates the state in place and returns it; beside it
        # six float32 metrics
        metrics = spec_of(torch.empty((6,), device=META), (), mesh_shape)
        specs = {"params": st["params"], "opt": st["opt"], "batch": batch,
                 "out": metrics, "alias": [st["params"], st["opt"]]}
        return make_train_step(cfg, tcfg), (state, _tensors(batch)), specs

    params = abstract_params(cfg)
    p_specs = params_shardings(params, mesh_shape, rules)
    # the logits by the rules' ("batch", None, "vocab"), filtered
    logits = torch.empty((B, 1, cfg.vocab_size), device=META)
    logits = spec_of(logits, filter_spec((dp if B > 1 else None, None,
                                          "model"), logits.shape,
                                         mesh_shape), mesh_shape)
    if shape.kind == "prefill":
        batch = prefill_specs(cfg, shape, mesh_shape)

        @torch.no_grad()
        def prefill(params, batch):
            enc_out = None
            if cfg.is_encdec:
                enc_out = encode(params, cfg, batch["enc_embeds"])
            hidden, _, _ = forward_hidden(params, cfg,
                                          tokens=batch["tokens"],
                                          enc_out=enc_out)
            return logits_from_embedding(hidden[:, -1:], params.embed,
                                         cap=cfg.logit_softcap)

        specs = {"params": p_specs, "batch": batch, "out": logits,
                 "alias": []}
        return prefill, (params, _tensors(batch)), specs

    states, s_specs = decode_state_specs(cfg, shape, mesh_shape)
    dbatch = decode_batch_specs(cfg, shape, mesh_shape)
    cur_pos = shape.seq_len - 1

    @torch.no_grad()
    def serve_step(params, states, token, *rest):
        enc_out = rest[0] if rest else None
        return decode_step(params, cfg, token, states, cur_pos,
                           enc_out=enc_out)

    # the attention caches are written in place; the recurrent states
    # come back new
    leaves = [part for st in s_specs for part in st.values()]
    cached = [p for p in leaves if set(p) == {"k", "v"}]
    fresh = [p for p in leaves if set(p) != {"k", "v"}]
    args = [params, states, dbatch["token"].tensor]
    if cfg.is_encdec:
        args.append(dbatch["enc_out"].tensor)
    specs = {"params": p_specs, "states": s_specs, "batch": dbatch,
             "out": [logits, fresh], "alias": cached}
    return serve_step, tuple(args), specs


def cell_config(arch: str, shape_name: str) -> tuple[ModelConfig,
                                                      ShapeConfig]:
    """A cell's config and shape; a train cell runs with per-period remat
    (``remat="full"``), as the JAX package's dry run does."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = cfg.replace(remat="full")     # per-layer remat (§Perf iter. 6)
    return cfg, shape


def build_cell(arch: str, shape_name: str, mesh_shape: dict, rules=None):
    """(cfg, fn, args, specs) of a cell (`step_cell` of `cell_config`)."""
    cfg, shape = cell_config(arch, shape_name)
    return (cfg, *step_cell(cfg, shape, mesh_shape, rules))


def count_cell(arch: str, shape_name: str) -> dict:
    """`op_stats.scaled_count` of a cell's step on ``meta`` (the mesh plays
    no part in it), with its seconds."""
    cfg, shape = cell_config(arch, shape_name)
    mesh_shape = production_mesh_shape()
    # a decode step's length is its cache's: the step is not affine in it
    seq_len = shape.seq_len if shape.kind != "decode" else 1

    def build(c, S):
        sh = shape if shape.kind == "decode" else \
            ShapeConfig(shape.name, S, shape.global_batch, shape.kind)
        fn, args, _ = step_cell(c, sh, mesh_shape)
        return fn, args

    t0 = time.perf_counter()
    stats = scaled_count(build, cfg, seq_len)
    stats["count_s"] = time.perf_counter() - t0
    return stats


def train_step_args(cfg: ModelConfig, tcfg, batch: int, seq_len: int, *,
                    device=META, seed: int = 0):
    """(step, (state, batch)) of a train step of `cfg` on ``[batch,
    seq_len]`` tokens with a loss mask (as the data plane's batches carry
    one) on `device`: on ``meta`` the abstract state; elsewhere `lm_init`
    from `seed`, its state and seeded tokens."""
    dev = torch.device(device)
    shape = (batch, seq_len)
    if dev.type == "meta":
        state = abstract_train_state(cfg, tcfg)
        toks = torch.empty((batch, seq_len + 1), dtype=torch.int32,
                           device=dev)
        enc = torch.empty((batch, cfg.enc_seq, cfg.d_model), device=dev)
    else:
        state = make_train_state(lm_init(cfg, seed=seed, device=dev), tcfg)
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1),
                             generator=g, device=dev, dtype=torch.int32)
        enc = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=g,
                          device=dev)
    b = {"tokens": toks, "loss_mask": torch.ones(shape, device=dev)}
    if cfg.is_encdec:
        b["enc_embeds"] = enc
    return make_train_step(cfg, tcfg), (state, b)


def state_nbytes(state: dict) -> dict:
    """The bytes of a train state's parameters and optimizer state."""
    return {"params": sum(p.numel() * p.element_size()
                          for p in state["params"].parameters()),
            "opt": sum(t.numel() * t.element_size()
                       for t in walk(state["opt"]))}


def _part_flops(fn, leaves) -> tuple[int, int]:
    """(forward, forward + backward) FLOPs of ``fn()`` (a tensor, or a
    tuple of those the step uses), its backward taken to every leaf of
    `leaves`."""
    forward = count(fn)["flops"]

    def both():
        out = fn()
        outs = [t for t in (out if isinstance(out, tuple) else (out,))
                if t.requires_grad]
        torch.autograd.grad(outs, leaves, [torch.ones_like(t) for t in outs])
    return forward, count(both)["flops"]


def flop_split(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The dot FLOPs of a train step of `cfg` on ``[batch, seq_len]``
    tokens by part: "attention" (projections, scores and values; self,
    cross and the encoder's), "recurrent" (the RG-LRU and the RWKV6 time
    mix), "mlp" (the dense MLP and the RWKV6 channel mix), "experts" (the
    MoE with its router) and "unembedding" (the loss's logits). Each part
    runs alone on ``meta`` at the step's shapes, forward and backward,
    once a layer kind; a layer of the periods counts its forward twice
    under ``remat="full"``; times the layers of that kind. (The backward's
    recompute of a period stops after the last op whose result the
    backward needs, so a period whose last product feeds nothing saved,
    such as a dense MLP's down projection, recomputes all but that: one
    run of a whole period gives what its last part does not redo.)"""
    model = abstract_params(cfg)
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    remat = cfg.remat == "full"

    def act(T):
        return torch.empty((batch, T, cfg.d_model), dtype=COMPUTE_DTYPE,
                           device=META, requires_grad=True)

    x, enc = act(seq_len), act(cfg.enc_seq)
    out = dict.fromkeys(("attention", "recurrent", "mlp", "experts",
                         "unembedding"), 0)

    def add(name, fn, leaves, times, recompute):
        fwd, both = _part_flops(fn, leaves)
        out[name] += times * (both + (fwd if recompute else 0))
        return both + (fwd if recompute else 0), name

    def block(bp, times, recompute, causal=True):
        kind = bp.kind if hasattr(bp, "kind") else "b"
        # each part's outputs that the step uses (not the decode states)
        mods = [("attention", bp.attn, lambda: attention_layer(
                    bp.attn, cfg, x, is_local=kind == "l",
                    causal=causal)[0])
                if kind in ("g", "l") else
                ("recurrent", bp.rnn, lambda: rglru_layer(bp.rnn, cfg, x)[0])
                if kind == "r" else
                ("recurrent", bp.tmix, lambda: rwkv_time_mix(bp.tmix, cfg,
                                                             x)[0])]
        if hasattr(bp, "xattn"):
            mods.append(("attention", bp.xattn, lambda: attention_layer(
                bp.xattn, cfg, x, is_local=False, causal=False,
                kv_override=_cross_kv(bp.xattn, enc))[0]))
        if kind == "w":
            mods.append(("mlp", bp.cmix,
                         lambda: rwkv_channel_mix(bp.cmix, cfg, x)[0]))
        elif cfg.is_moe:
            mods.append(("experts", bp.moe, lambda: moe_layer(bp.moe, cfg, x)))
        else:
            mods.append(("mlp", bp.mlp, lambda: mlp_layer(bp.mlp, cfg, x)))
        done = []
        for name, mod, fn in mods:
            leaves = [x, *mod.parameters()] + \
                ([enc] if mod is getattr(bp, "xattn", None) else [])
            done.append(add(name, fn, leaves, times, recompute))
        return done

    done = [part for j in range(P)
            for part in block(model.blocks[j], n_full, remat)]
    if remat and n_full:
        blocks = list(model.blocks[:P])
        enc_out = enc if cfg.is_encdec else None
        leaves = [x, *(p for b in blocks for p in b.parameters())] + \
            ([enc] if cfg.is_encdec else [])
        _, period = _part_flops(lambda: checkpoint(
            _run_blocks, blocks, cfg, x, enc_out, use_reentrant=False),
            leaves)
        out[done[-1][1]] += n_full * (period - sum(f for f, _ in done))
    for j in range(cfg.n_layers - n_full * P):
        block(model.blocks[n_full * P + j], 1, False)
    if cfg.is_encdec:
        eb = model.enc[0]
        add("attention", lambda: attention_layer(
            eb.attn, cfg, enc, is_local=False, causal=False)[0],
            [enc, *eb.attn.parameters()], cfg.encoder_layers, False)
        add("mlp", lambda: mlp_layer(eb.mlp, cfg, enc),
            [enc, *eb.mlp.parameters()], cfg.encoder_layers, False)
    targets = torch.empty((batch, seq_len), dtype=torch.int32, device=META)
    add("unembedding", lambda: chunked_softmax_xent(
        x, model.embed, targets, cap=cfg.logit_softcap)[0],
        [x, model.embed], 1, False)
    return out


def tree_nbytes(tree, per_device: bool = False) -> int:
    """The bytes of a tree of `Spec` s: per device, or on one card."""
    return sum(s.shard_nbytes if per_device else s.nbytes
               for s in walk(tree))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             rules=None, tag: str = "", counted: dict | None = None) -> dict:
    """One cell on one mesh: its record (written to ``out_dir`` as
    ``{arch}__{shape}__{mesh}{tag}.json`` unless ``out_dir`` is empty).
    `counted` is the cell's `count_cell` (or the exception it raised),
    reused across meshes."""
    mesh_shape = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": mesh_num_devices(mesh_shape), "tag": tag}
    t0 = time.perf_counter()
    try:
        cfg, _, _, specs = build_cell(arch, shape_name, mesh_shape, rules)
        st = counted if counted is not None else \
            count_cell(arch, shape_name)
        if isinstance(st, Exception):
            raise st
        rec["flops"] = rec["flops_corrected"] = float(st["flops"])
        rec["bytes"] = rec["bytes_corrected"] = float(st["bytes"])
        args = {k: specs[k] for k in ("params", "opt", "batch", "states")
                if k in specs}
        rec["argument_size_in_bytes"] = tree_nbytes(args, True)
        rec["output_size_in_bytes"] = tree_nbytes(specs["out"], True)
        rec["alias_size_in_bytes"] = tree_nbytes(specs["alias"], True)
        rec["temp_size_in_bytes"] = int(st["peak_bytes"])
        rec["argument_size_in_bytes_one_card"] = tree_nbytes(args, False)
        rec["argument_bytes_one_card_by_part"] = {
            k: tree_nbytes(v, False) for k, v in args.items()}
        rec["model_flops"] = model_flops_estimate(cfg, SHAPES[shape_name])
        rec["count"] = {"runs": st["runs"], "scaled": st["scaled"],
                        "seconds": st["count_s"]}
        rec["status"] = "ok"
    except Exception as e:  # record failures — they are bugs to fix
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in model_archs()
                 for s in SHAPES if cell_runs(get_config(a), s)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    failed = 0
    for arch, shape_name in cells:
        counted = None
        for mk in meshes:
            fname = os.path.join(args.out,
                                 f"{arch}__{shape_name}__{mk}.json")
            if args.skip_existing and os.path.exists(fname):
                print(f"skip {arch} {shape_name} {mk}")
                continue
            if counted is None:
                try:
                    counted = count_cell(arch, shape_name)
                except Exception as e:  # run_cell records it
                    counted = e
            rec = run_cell(arch, shape_name, mk, args.out, counted=counted)
            ok = rec["status"]
            failed += ok != "ok"
            count_s = rec.get("count", {}).get("seconds", 0.0)
            print(f"{arch:22s} {shape_name:12s} {mk:6s} {ok:5s} "
                  f"count_s={count_s:7.2f} "
                  f"flops={rec.get('flops', -1):.3e} "
                  f"args/dev={rec.get('argument_size_in_bytes', -1):.3e} "
                  f"err={rec.get('error', '')[:90]}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
