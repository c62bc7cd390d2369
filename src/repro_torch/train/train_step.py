"""Train step builder: loss → grads (with remat policy) → clip →
(optional int8 error-feedback compression) → optimizer → new state, with
microbatch gradient accumulation.

The port of `repro.train.train_step`. A train state is ``{"params": LM,
"opt": optimizer state, ["ef_error": tree]}``. The step applies the
optimizer's update function (which returns new tensors, as the JAX
package's does) one leaf of the JAX package's layout at a time
(`repro_torch.models.convert.param_groups`: a pattern position's layers
stacked, ``[⌊L/P⌋, ...]``) and writes each result into the LM's
parameters and the state's tensors in place, so the LM passed to
`make_train_state` is the one that trains and the update holds one
leaf's new tensors at a time, not a second copy of every tree.

- AdamW and SGD+momentum are elementwise: their moments and the
  error-feedback residuals are kept a tensor a layer, flat dicts keyed by
  the LM's parameter names, and updated layer by layer.
- Adafactor's factored moments and its update clip span the stacked
  leaf, so its ``f`` is the JAX package's, keyed by that package's leaf
  names (``"blocks.l0.attn.wq"``), and a stacked leaf is updated whole:
  its layers' parameters and gradients are stacked, updated and copied
  back.
- The int8 error-feedback quantises each stacked leaf with one scale, as
  the JAX package does.

`state_tree` gives the state as the JAX package's tree (what its
`make_train_state` gives and its checkpoints hold) and `load_state_tree`
puts such a tree back onto the state's device, so a checkpoint of either
package resumes in the other.

Remat (`TrainConfig.remat`) is a memory policy with the same values:
"full" wraps the whole loss in `torch.utils.checkpoint` (the backward
recomputes everything), "save_dots" in a selective checkpoint that keeps
the outputs of the matrix products (``mm``, ``bmm``, ``addmm``) and
recomputes the rest, the counterpart of ``checkpoint_dots``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..models.convert import (load_train_state_from_jax, param_groups,
                              train_state_to_jax)
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
    remat: str = "none"          # none | full | save_dots

#: the ops whose outputs "save_dots" keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def make_loss_fn(cfg, remat: str = "none"):
    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch)
    if remat == "none":
        return loss_fn
    if remat == "full":
        kw = {}
    elif remat == "save_dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, list(_DOTS))}
    else:
        raise ValueError(f"unknown remat {remat!r}")

    def remat_loss_fn(params, batch):
        return checkpoint(loss_fn, params, batch, use_reentrant=False, **kw)
    return remat_loss_fn


def _named(model) -> dict:
    return dict(model.named_parameters())


def _stack(ts: list, stacked: bool) -> torch.Tensor:
    return torch.stack(ts) if stacked else ts[0]


def _unstack(t: torch.Tensor, stacked: bool) -> list:
    return list(t) if stacked else [t]


def make_train_state(params, tcfg: TrainConfig) -> dict:
    """The train state of the `LM` `params` (which the step then trains
    in place)."""
    init, _ = make_optimizer(tcfg.opt)
    leaves = {k: p.detach() for k, p in _named(params).items()}
    if tcfg.opt.name == "adafactor":
        # one entry per stacked leaf, made from views of its shape that
        # hold no memory
        like = {}
        for ref, (names, stacked) in param_groups(params).items():
            p = leaves[names[0]]
            like[ref] = p.expand((len(names),) + p.shape) if stacked else p
        opt = init(like)
    else:
        opt = init(leaves)
    state = {"opt": opt, "params": params}
    if tcfg.opt.compress:
        state["ef_error"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), leaves)
    return state


#: the state as the JAX package's train-state tree (host numpy arrays), for
#: `repro_torch.ckpt.save_checkpoint`.
state_tree = train_state_to_jax
#: copy a restored tree of `state_tree`'s structure into a state, in place.
load_state_tree = load_train_state_from_jax


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
        lr = sched(state["opt"]["step"])
        opt = state["opt"]
        factored = tcfg.opt.name == "adafactor"
        params = {k: p.detach() for k, p in _named(model).items()}
        step = None

        def update(key, p, g):
            """The optimizer on one leaf; its state written back in place."""
            nonlocal step
            leaf = {k: tree if k == "step" else {key: tree[key]}
                    for k, tree in opt.items()}
            new_p, new_leaf = opt_update({key: p}, {key: g}, leaf, lr=lr)
            for k, tree in new_leaf.items():
                if k != "step":
                    tree_map(lambda dst, src: dst.copy_(src), opt[k][key],
                             tree[key])
            step = new_leaf["step"]
            return new_p[key]

        with torch.no_grad():
            for ref, (names, stacked) in param_groups(model).items():
                ps = [params[n] for n in names]
                # each gradient is dropped once its update is done
                gs = {n: grads.pop(n) for n in names}
                if tcfg.opt.compress:
                    errs = [state["ef_error"][n] for n in names]
                    new_g, new_e = compressed_grads_with_feedback(
                        {ref: _stack([gs.pop(n) for n in names], stacked)},
                        {ref: _stack(errs, stacked)})
                    for dst, src in zip(errs, _unstack(new_e[ref], stacked)):
                        dst.copy_(src)
                    gs = dict(zip(names, _unstack(new_g.pop(ref), stacked)))
                if factored:
                    new_p = update(ref, _stack(ps, stacked), _stack(
                        [gs.pop(n) for n in names], stacked))
                    for dst, src in zip(ps, _unstack(new_p, stacked)):
                        dst.copy_(src)
                else:
                    for n, p in zip(names, ps):
                        p.copy_(update(n, p, gs.pop(n)))
        new_state = {"opt": dict(opt, step=step), "params": model}
        if tcfg.opt.compress:
            new_state["ef_error"] = state["ef_error"]
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


__all__ = ["TrainConfig", "load_state_tree", "make_loss_fn",
           "make_train_state", "make_train_step", "state_tree"]
