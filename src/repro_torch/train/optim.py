"""Optimizers built from scratch: AdamW, Adafactor (factored second moment),
SGD+momentum; global-norm clipping; int8 error-feedback gradient
compression.

The port of `repro.train.optim`: functions on trees (nested dicts whose
leaves are tensors) that return new trees, as the JAX package's do, in
its float32 arithmetic. `torch.optim` is not used.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    momentum: float = 0.9
    compress: bool = False       # int8 error-feedback compression


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (nested dicts); `rest` are walked
    alongside, and the subtree of each at a leaf of `tree` is passed whole
    (as ``jax.tree_util.tree_map`` does with a prefix tree). Walked with
    an explicit stack; the keys keep their order."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    out: dict = {}
    stack = [(tree, rest, out)]
    while stack:
        node, others, dst = stack.pop()
        for k, sub in node.items():
            subs = tuple(o[k] for o in others)
            if isinstance(sub, dict):
                dst[k] = {}
                stack.append((sub, subs, dst[k]))
            else:
                dst[k] = fn(sub, *subs)
    return out


def tree_leaves(tree) -> list:
    """The leaves of `tree` (nested dicts), depth first in key order."""
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        else:
            out.append(node)
    return out


def _pick(out, i: int):
    return tree_map(lambda t: t[i], out)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# --------------------------------------------------------------------------
# gradient clipping
# --------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------------
# int8 error-feedback compression
# --------------------------------------------------------------------------
def compress_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    a = torch.amax(torch.abs(g.float()))
    scale = torch.clamp(a, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_grads_with_feedback(grads, errors):
    """Quantise grads + carry the quantisation error into the next step."""
    def one(g, e):
        g32 = g.float() + e
        q, s = compress_int8(g32)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), (g32 - deq)
    out = tree_map(one, grads, errors)
    return _pick(out, 0), _pick(out, 1)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def adamw_init(params):
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adamw_update(params, grads, state, cfg: OptConfig, lr):
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v):
        g32 = g.float()
        m_ = cfg.b1 * m + (1 - cfg.b1) * g32
        v_ = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh, vh = m_ / c1, v_ / c2
        # eps outside the root; weight decay on every leaf
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m_, v_

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) — factored second moment, no first moment
# --------------------------------------------------------------------------
def adafactor_init(params):
    def one(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": _zeros_f32(p)}
    return {"f": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adafactor_update(params, grads, state, cfg: OptConfig, lr):
    step = state["step"] + 1
    t = step.float()
    beta2 = 1.0 - t ** -0.8
    eps = 1e-30

    def upd(p, g, s):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if p.ndim >= 2:
            vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=eps)
            vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            upd_ = g32 / torch.sqrt(vhat + eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            upd_ = g32 / torch.sqrt(v + eps)
            new_s = {"v": v}
        # update clipping (RMS ≤ 1) as in the paper
        rms = torch.sqrt(torch.mean(torch.square(upd_)) + eps)
        upd_ = upd_ / torch.clamp(rms, min=1.0)
        new_p = (p.float() * (1 - lr * cfg.weight_decay)
                 - lr * upd_).to(p.dtype)
        return new_p, new_s

    # the state["f"] subtree at each param leaf is the {"vr","vc"}/{"v"}
    # dict, passed whole to `upd`
    out = tree_map(upd, params, grads, state["f"])
    return _pick(out, 0), {"f": _pick(out, 1), "step": step}


# --------------------------------------------------------------------------
# SGD + momentum
# --------------------------------------------------------------------------
def sgdm_init(params):
    return {"m": tree_map(_zeros_f32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def sgdm_update(params, grads, state, cfg: OptConfig, lr):
    def upd(p, g, m):
        m_ = cfg.momentum * m + g.float()
        return (p.float() - lr * m_).to(p.dtype), m_
    out = tree_map(upd, params, grads, state["m"])
    return _pick(out, 0), {"m": _pick(out, 1), "step": state["step"] + 1}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "sgdm": (sgdm_init, sgdm_update),
}


def make_optimizer(cfg: OptConfig):
    init, update = OPTIMIZERS[cfg.name]
    return init, functools.partial(update, cfg=cfg)
