"""LR schedules: cosine and WSD (warmup–stable–decay, MiniCPM
arXiv:2404.06395).

The port of `repro.train.schedule`: float32 tensor arithmetic on the
step, in the JAX package's order of operations.
"""
from __future__ import annotations

import math

import torch


def _t(step):
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    t = _t(step)
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(t < warmup, warm, cos)


def wsd_schedule(step, *, base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup → stable plateau → fast exponential-ish (linear here) decay in
    the final `decay_frac` of training."""
    t = _t(step)
    decay_start = total * (1.0 - decay_frac)
    warm = t / max(warmup, 1)
    dec = 1.0 - (1.0 - min_ratio) * torch.clamp(
        (t - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
    return base_lr * torch.where(
        t < warmup, warm, torch.where(t < decay_start, 1.0, dec))


def make_schedule(name: str, **kw):
    fn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[name]
    return lambda step: fn(step, **kw)
