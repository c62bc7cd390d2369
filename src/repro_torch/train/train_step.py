"""Train step builder: loss → grads → clip → (optional int8
error-feedback compression) → optimizer → new state, with microbatch
gradient accumulation.

The port of `repro.train.train_step`. A train state is ``{"params": LM,
"opt": optimizer state, ["ef_error": tree]}``; the optimizer's trees are
flat dicts keyed by the LM's parameter names. The step computes new
parameters as the JAX package does (new tensors from the optimizer
functions) and then writes them into the LM's parameters in place, so the
LM passed to `make_train_state` is the one that trains. `state_tree` and
`load_state_tree` give the checkpointable tree of a state and put one
back onto the state's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.lm import lm_loss
from .optim import (OptConfig, clip_by_global_norm,
                    compressed_grads_with_feedback, make_optimizer,
                    tree_map)
from .schedule import make_schedule


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    schedule: str = "cosine"
    warmup: int = 100
    total_steps: int = 10_000
    microbatches: int = 1        # grad accumulation
    remat: str = "none"          # none (full | save_dots: ROADMAP item 2b)


def make_loss_fn(cfg, remat: str = "none"):
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP queue 1, item 2b)")

    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch)
    return loss_fn


def _named(model) -> dict:
    return dict(model.named_parameters())


def make_train_state(params, tcfg: TrainConfig) -> dict:
    """The train state of the `LM` `params` (which the step then trains
    in place)."""
    init, _ = make_optimizer(tcfg.opt)
    leaves = {k: p.detach() for k, p in _named(params).items()}
    state = {"opt": init(leaves), "params": params}
    if tcfg.opt.compress:
        state["ef_error"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), leaves)
    return state


def state_tree(state: dict) -> dict:
    """The state as a tree of tensors (the LM as its named parameters),
    for `repro_torch.ckpt.save_checkpoint`."""
    return dict(state, params={k: p.detach()
                               for k, p in _named(state["params"]).items()})


def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a restored tree (numpy leaves, `state_tree`'s structure) into
    `state` on its device; returns `state`."""
    def put(dst, src):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(np.asarray(src)))
        return dst
    tree_map(put, state_tree(state), tree)
    return state


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves (numpy arrays or tensors) have leading dims
    [microbatches, per_mb_batch, ...] when tcfg.microbatches > 1, else
    [batch, ...]. An optional "loss_mask" leaf ([..., S] float32, 1 =
    count the target) flows through to `lm_loss` and surfaces as a
    ``masked_frac`` metric. Metrics are 0-d tensors on the state's device.
    """
    _, opt_update = make_optimizer(tcfg.opt)
    sched = make_schedule(
        tcfg.schedule, base_lr=tcfg.opt.lr, warmup=tcfg.warmup,
        total=tcfg.total_steps)
    loss_fn = make_loss_fn(cfg, remat=tcfg.remat)

    def grad_fn(model, names, leaves, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(names, grads))

    def compute_grads(model, batch):
        names, leaves = zip(*_named(model).items())
        if tcfg.microbatches <= 1:
            return grad_fn(model, names, leaves, batch)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in zip(names, leaves)}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for k in range(tcfg.microbatches):
            mb = {key: v[k] for key, v in batch.items()}
            loss, metrics, grads = grad_fn(model, names, leaves, mb)
            acc = {n: acc[n] + grads[n].float() for n in names}
            loss_sum = loss_sum + loss
        inv = 1.0 / tcfg.microbatches
        grads = {n: g * inv for n, g in acc.items()}
        # the metrics of the last microbatch
        return loss_sum * inv, metrics, grads

    def train_step(state, batch):
        model = state["params"]
        batch = _to_device(batch, model.device)
        loss, metrics, grads = compute_grads(model, batch)
        if "loss_mask" in batch:
            # fraction of targets zeroed by the contamination gate's mask
            # policy (repro_torch.data.pipeline.ContaminationGate)
            metrics = dict(metrics,
                           masked_frac=1.0 - torch.mean(batch["loss_mask"]))
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.clip_norm)
        if tcfg.opt.compress:
            grads, new_err = compressed_grads_with_feedback(
                grads, state["ef_error"])
        lr = sched(state["opt"]["step"])
        params = {k: p.detach() for k, p in _named(model).items()}
        new_params, new_opt = opt_update(params, grads, state["opt"], lr=lr)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        new_state = {"opt": new_opt, "params": model}
        if tcfg.opt.compress:
            new_state["ef_error"] = new_err
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


__all__ = ["TrainConfig", "load_state_tree", "make_loss_fn",
           "make_train_state", "make_train_step", "state_tree"]
