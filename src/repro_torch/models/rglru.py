"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(−c · softplus(Λ) · r_t),  r_t, i_t input-dependent sigmoid gates.

The port of `repro.models.rglru`. The JAX package evaluates the linear
recurrence with ``jax.lax.associative_scan``; here it is a log-depth
(Hillis-Steele) scan in PyTorch ops, ⌈log₂ S⌉ rounds, each out of place
so that autograd keeps its inputs. The two compose the same pairs in
another order, so the float32 results agree to rounding. Decode carries
(h, conv) state for O(1) per-token cost.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import _param
from .layers import COMPUTE_DTYPE, activation, product_f32

_C = 8.0


class RGLRU(nn.Module):
    """The parameters of one RG-LRU block (`init_rglru`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_rglru(self, cfg, device)


def init_rglru(mod: nn.Module, cfg, device=None) -> None:
    D = cfg.lru_dim or cfg.d_model
    d = cfg.d_model
    mod.w_x = _param((d, D), device=device)
    mod.w_gate = _param((d, D), device=device)
    mod.conv = _param((cfg.conv_width, D), device=device)
    mod.w_rg = _param((D, D), device=device)
    mod.w_ig = _param((D, D), device=device)
    mod.lam = _param((D,), init="ones", device=device)
    mod.w_out = _param((D, d), scale=0.02 / np.sqrt(2 * cfg.n_layers),
                       device=device)


def _causal_conv(x, kernel, state=None):
    """x [B, S, D]; kernel [W, D] depthwise causal. state [B, W-1, D]."""
    W = kernel.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * kernel[i].to(x.dtype)
              for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return out, new_state


def _gates(p, u):
    r = torch.sigmoid(product_f32("...d,de->...e", u, p.w_rg))
    i = torch.sigmoid(product_f32("...d,de->...e", u, p.w_ig))
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i


def linear_scan(a, b):
    """h_t = a_t · h_{t-1} + b_t along dim 1 from h_{-1} = 0, in
    ⌈log₂ S⌉ rounds: after the round of offset o, (a, h) at t compose
    the steps t-2o+1 .. t."""
    h = b
    o = 1
    while o < a.shape[1]:
        h = torch.cat([h[:, :o], a[:, o:] * h[:, :-o] + h[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return h


def rglru_layer(p, cfg, x, *, state=None):
    """x [B, S, d] → ([B, S, d], new_state). state = {h, conv} for decode."""
    u = product_f32("bsd,de->bse", x, p.w_x).to(COMPUTE_DTYPE)
    gate = product_f32("bsd,de->bse", x, p.w_gate)
    u, conv_state = _causal_conv(
        u, p.conv, None if state is None else state["conv"])

    a, b_scale = _gates(p, u)
    b = b_scale * u.float()

    if state is None:
        h = linear_scan(a, b)
        new_state = None if conv_state is None else {
            "h": h[:, -1], "conv": conv_state}
    else:
        # the JAX package's stateful branch, as it is: it applies the
        # carried h to every position, which is the recurrence only for
        # S = 1, the one case decode uses
        h = a * state["h"][:, None].float() + b
        new_state = {"h": h[:, -1], "conv": conv_state}

    out = h.to(COMPUTE_DTYPE) * activation("gelu")(gate).to(COMPUTE_DTYPE)
    out = product_f32("bse,ed->bsd", out, p.w_out)
    return out.to(COMPUTE_DTYPE), new_state


def init_rglru_state(cfg, B: int, *, device="cuda"):
    D = cfg.lru_dim or cfg.d_model
    return {"h": torch.zeros((B, D), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, D),
                                dtype=COMPUTE_DTYPE, device=device)}


__all__ = ["RGLRU", "init_rglru", "init_rglru_state", "linear_scan",
           "rglru_layer"]
