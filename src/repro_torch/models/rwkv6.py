"""RWKV6 "Finch" time-mix + channel-mix (arXiv:2404.05892), attention-free.

Time-mix recurrence per head (hd = head dim, state S ∈ R^{hd×hd}):
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ           (data-dependent decay w_t)

The port of `repro.models.rwkv6`. The JAX package's ``lax.scan`` over
time is a Python loop over the S positions here, in float32, with the
same operations in the same order; autograd keeps one [B, H, hd, hd]
state a step. Decode is O(1)/token carrying (x_prev, S).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import _param
from .layers import COMPUTE_DTYPE, product_f32, rms_norm


class TimeMix(nn.Module):
    """The parameters of one RWKV6 time-mix (`init_rwkv_time_mix`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_rwkv_time_mix(self, cfg, device)


class ChannelMix(nn.Module):
    """The parameters of one RWKV6 channel-mix (`init_rwkv_channel_mix`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_rwkv_channel_mix(self, cfg, device)


def init_rwkv_time_mix(mod: nn.Module, cfg, device=None) -> None:
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.hd
    for nm in ("r", "k", "v", "g", "w"):
        setattr(mod, f"mu_{nm}", _param((d,), init="zeros", device=device))
    mod.w_r = _param((d, H * hd), device=device)
    mod.w_k = _param((d, H * hd), device=device)
    mod.w_v = _param((d, H * hd), device=device)
    mod.w_g = _param((d, H * hd), device=device)
    mod.w_w = _param((d, H * hd), scale=0.001, device=device)
    mod.w0 = _param((H * hd,), init="zeros", device=device)
    mod.u = _param((H, hd), scale=0.1, device=device)
    mod.ln_x = _param((H * hd,), init="zeros", device=device)
    mod.w_out = _param((H * hd, d), scale=0.02 / np.sqrt(2 * cfg.n_layers),
                       device=device)


def _token_shift(x, mu, x_prev):
    """lerp(x_{t-1}, x_t, μ). x [B,S,d]; x_prev [B,1,d] (decode carry)."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mu = mu.to(x.dtype)
    return x * (1 + mu) - shifted * mu  # x + μ(x − x_{t−1}) form


def rwkv_time_mix(p, cfg, x, *, state=None):
    """x [B, S, d] → (out, new_state). state = {"x_prev": [B,1,d],
    "S": [B,H,hd,hd]} for decode / chunk continuation."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    x_prev = (x.new_zeros((B, 1, d)) if state is None
              else state["x_prev"].to(x.dtype))

    def proj(nm):
        xs = _token_shift(x, getattr(p, f"mu_{nm}"), x_prev)
        return product_f32("bsd,de->bse", xs, getattr(p, f"w_{nm}"))

    r = proj("r").reshape(B, S, H, hd)
    k = proj("k").reshape(B, S, H, hd)
    v = proj("v").reshape(B, S, H, hd)
    g = proj("g")
    w = torch.exp(-torch.exp(
        torch.clamp(p.w0.float() + proj("w"), -20, 10)
    )).reshape(B, S, H, hd)                               # decay ∈ (0,1)
    u = p.u.float()

    Sm = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state["S"])
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # [B,H,hd]
        kv = k_t[..., :, None] * v_t[..., None, :]        # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               Sm + u[None, :, :, None] * kv))
        Sm = w_t[..., :, None] * Sm + kv
    y = torch.stack(ys, dim=1).reshape(B, S, H * hd)      # [B,S,H*hd]

    y = rms_norm(y.to(COMPUTE_DTYPE), p.ln_x, cfg.norm_eps)
    y = y * F.silu(g).to(COMPUTE_DTYPE)
    out = product_f32("bse,ed->bsd", y, p.w_out)
    new_state = {"x_prev": x[:, -1:].to(COMPUTE_DTYPE), "S": Sm}
    return out.to(COMPUTE_DTYPE), new_state


def init_rwkv_channel_mix(mod: nn.Module, cfg, device=None) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    mod.mu_k = _param((d,), init="zeros", device=device)
    mod.mu_r = _param((d,), init="zeros", device=device)
    mod.w_k = _param((d, ff), device=device)
    mod.w_r = _param((d, d), device=device)
    mod.w_v = _param((ff, d), scale=0.02 / np.sqrt(2 * cfg.n_layers),
                     device=device)


def rwkv_channel_mix(p, cfg, x, *, state=None):
    B, S, d = x.shape
    x_prev = (x.new_zeros((B, 1, d)) if state is None
              else state["x_prev"].to(x.dtype))
    xk = _token_shift(x, p.mu_k, x_prev)
    xr = _token_shift(x, p.mu_r, x_prev)
    k = product_f32("bsd,df->bsf", xk, p.w_k)
    k = torch.square(F.relu(k)).to(COMPUTE_DTYPE)
    kv = product_f32("bsf,fd->bsd", k, p.w_v)
    r = torch.sigmoid(product_f32("bsd,de->bse", xr, p.w_r))
    out = (r * kv).to(COMPUTE_DTYPE)
    return out, {"x_prev": x[:, -1:].to(COMPUTE_DTYPE)}


def init_rwkv_state(cfg, B: int, *, device="cuda"):
    H, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {
        "tm": {"x_prev": torch.zeros((B, 1, d), dtype=COMPUTE_DTYPE,
                                     device=device),
               "S": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=device)},
        "cm": {"x_prev": torch.zeros((B, 1, d), dtype=COMPUTE_DTYPE,
                                     device=device)},
    }


__all__ = ["ChannelMix", "TimeMix", "init_rwkv_channel_mix",
           "init_rwkv_state", "init_rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_time_mix"]
