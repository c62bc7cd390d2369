"""GQA attention: flash-style blocked softmax (train/prefill), ring-buffer KV
caches (decode), sliding-window local layers, gemma-style softcaps, qk-norm.

The port of `repro.models.attention`, in PyTorch ops. The blocked
implementation never materialises the [S, T] score matrix: it loops over
query chunks and, per query chunk, only the causally/window reachable KV
chunks. Scores, softmax statistics and accumulators are float32; the
products take bf16-rounded operands into float32 sums
(`layers.bf16_product_f32`), as the JAX package's bf16 einsums with a
float32 result do. Masked scores become `NEG_INF` after the softcap.

Differences of form, not of value: the JAX package's ``lax.scan`` loops
are Python loops here, and a KV chunk past a query chunk's causal reach is
skipped by a Python test, where the JAX package takes ``lax.cond``. The
decode cache is written in place (`update_cache`). The JAX package wraps
`flash_attention` in ``jax.checkpoint`` (a memory policy: the backward
recomputes score blocks); here autograd keeps the blocks, which the
full-width training step has room for.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .layers import apply_rope, bf16_product_f32, rms_norm, softcap

NEG_INF = -1e30


def _chunk(x, n):  # [B, S, ...] -> [B, nchunks, n, ...]
    B, S = x.shape[:2]
    return x.reshape((B, S // n, n) + tuple(x.shape[2:]))


def flash_attention(
    q,                      # [B, S, H, hd]
    k,                      # [B, T, Hk, hd]
    v,                      # [B, T, Hk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
    attn_softcap: float | None = None,
    q_offset: int = 0,      # absolute position of q[0] (prefill continuation)
    q_chunk: int = 512,
    kv_chunk: int = 512,
):
    B, S, H, hd = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qc = min(q_chunk, S)
    kc = min(kv_chunk, T)
    S_true, T_true = S, T
    dev = q.device
    # pad to chunk multiples; padded kv is masked out, padded q is dropped
    if S % qc:
        pad = qc - S % qc
        q = torch.cat([q, q.new_zeros((B, pad, H, hd))], dim=1)
        S += pad
    if T % kc:
        pad = kc - T % kc
        k = torch.cat([k, k.new_zeros((B, pad, Hk, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, Hk, hd))], dim=1)
        T += pad
    nq, nk = S // qc, T // kc
    scale = 1.0 / math.sqrt(hd)

    qg = _chunk(q, qc).reshape(B, nq, qc, Hk, G, hd)
    kg = _chunk(k, kc)                                  # [B, nk, kc, Hk, hd]
    vg = _chunk(v, kc)

    # static chunk window: how many kv chunks back a q chunk can see
    if window is not None:
        back = int(math.ceil(window / kc)) + 1
    else:
        back = nk

    banded = window is not None and back < nk

    def _score_block(qblk, kblk, q_pos, kv_pos, extra_ok=None):
        """qblk [B,qc,Hk,G,hd]; kblk [B,C,Hk,hd] → masked scores
        [B,qc,Hk,G,C]."""
        s = bf16_product_f32("bqkgd,bckd->bqkgc", qblk, kblk) * scale
        s = softcap(s, attn_softcap)
        if T != T_true:
            ok = (kv_pos < T_true)[None, :].expand(qc, kv_pos.shape[0])
        else:
            ok = torch.ones((qc, kv_pos.shape[0]), dtype=torch.bool,
                            device=dev)
        if causal:
            ok = ok & (q_pos[:, None] >= kv_pos[None, :])
        if window is not None:
            ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
        if extra_ok is not None:
            ok = ok & extra_ok[None, :]
        return torch.where(ok[None, :, None, None, :], s, NEG_INF)

    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]                                # [B, qc, Hk, G, hd]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)

        if banded:
            # sliding window: gather the `back` reachable kv chunks and do a
            # single softmax over the band
            rel = qi - (back - 1) + torch.arange(back, device=dev)
            relc = torch.clamp(rel, 0, nk - 1)
            kb = kg[:, relc].reshape(B, back * kc, Hk, hd)
            vb = vg[:, relc].reshape(B, back * kc, Hk, hd)
            kv_pos = (rel[:, None] * kc
                      + torch.arange(kc, device=dev)[None, :]).reshape(-1)
            in_range = torch.repeat_interleave(rel >= 0, kc)
            s = _score_block(qblk, kb, q_pos, kv_pos, in_range)
            p = torch.softmax(s, dim=-1)
            out = bf16_product_f32("bqkgc,bckd->bqkgd", p, vb)
            outs.append(out.reshape(B, qc, H, hd).to(q.dtype))
            continue

        # global: online softmax over kv chunks; chunks past the causal
        # reach are skipped
        m = torch.full((B, qc, Hk, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, qc, Hk, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, Hk, G, hd), dtype=torch.float32,
                          device=dev)
        hi = min((q_offset + (qi + 1) * qc + kc - 1) // kc, nk) if causal \
            else nk
        for ki in range(hi):
            kv_pos = ki * kc + torch.arange(kc, device=dev)
            s = _score_block(qblk, kg[:, ki], q_pos, kv_pos)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + bf16_product_f32(
                "bqkgc,bckd->bqkgd", p, vg[:, ki])
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(B, qc, H, hd).to(q.dtype))

    out = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return out[:, :S_true]                              # [B, S, H, hd]


def decode_attention(
    q,                      # [B, 1, H, hd]
    cache_k,                # [B, C, Hk, hd]
    cache_v,
    cur_pos: int,           # absolute position of the new token
    *,
    window: int | None = None,
    attn_softcap: float | None = None,
):
    B, _, H, hd = q.shape
    C, Hk = cache_k.shape[1], cache_k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hk, G, hd)
    s = bf16_product_f32("bkgd,bckd->bkgc", qg, cache_k) * scale
    s = softcap(s, attn_softcap)
    # ring buffer: slot c holds position cur - ((cur - c) mod C)
    slots = torch.arange(C, device=q.device)
    pos_of_slot = cur_pos - torch.remainder(cur_pos - slots, C)
    ok = (pos_of_slot >= 0) & (pos_of_slot <= cur_pos)
    if window is not None:
        ok = ok & ((cur_pos - pos_of_slot) < window)
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = bf16_product_f32("bkgc,bckd->bkgd", p, cache_v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def update_cache(cache_k, cache_v, k_new, v_new, cur_pos: int):
    """Ring-buffer write of one position, in place (the JAX package returns
    new buffers). k_new [B, 1, Hk, hd]. Returns the caches."""
    slot = cur_pos % cache_k.shape[1]
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    return cache_k, cache_v


# --------------------------------------------------------------------------
# full attention layer (projections + rope + flash/decode)
# --------------------------------------------------------------------------
def _param(shape, *, scale: float = 0.02, init: str = "normal",
           device=None, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised parameter that carries its init rule
    (`repro.models.sharding.ParamCollector`'s: normal × scale, zeros or
    ones);
    `repro_torch.models.lm.reset_parameters` draws it."""
    p = nn.Parameter(torch.empty(tuple(shape), device=device, dtype=dtype))
    p.init_rule = (init, scale)
    return p


class Attention(nn.Module):
    """The parameters of one attention layer (`init_attention`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_attention(self, cfg, device)


def init_attention(mod: nn.Module, cfg, device=None) -> None:
    hd = cfg.hd
    mod.wq = _param((cfg.d_model, cfg.n_heads, hd), device=device)
    mod.wk = _param((cfg.d_model, cfg.n_kv_heads, hd), device=device)
    mod.wv = _param((cfg.d_model, cfg.n_kv_heads, hd), device=device)
    mod.wo = _param((cfg.n_heads, hd, cfg.d_model),
                    scale=0.02 / np.sqrt(2 * cfg.n_layers), device=device)
    if cfg.qk_norm:
        mod.q_norm = _param((hd,), init="zeros", device=device)
        mod.k_norm = _param((hd,), init="zeros", device=device)


def attention_layer(p, cfg, x, *, is_local: bool, positions=None,
                    cache=None, cur_pos=None, kv_override=None,
                    causal: bool = True):
    """x [B, S, d] bf16. Returns (out [B, S, d], new_cache).

    cache: None (training/prefill) or dict(k, v) ring buffers (decode, S=1),
    written in place. kv_override: (k, v) [B, T, Hk, hd] for
    cross-attention (the encoder's, `lm._cross_kv`): no k/v projection and
    no RoPE."""
    B, S, _ = x.shape
    window = cfg.window if is_local else None
    rope_base = (cfg.rope_base_local if (is_local and cfg.rope_base_local)
                 else cfg.rope_base)

    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    else:
        k, v = kv_override

    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)

    if positions is None:
        positions = (torch.arange(S, device=x.device)[None, :]
                     if cur_pos is None
                     else torch.full((B, S), cur_pos, device=x.device))
    if kv_override is None and rope_base:
        q = apply_rope(q, positions, rope_base)
        k = apply_rope(k, positions, rope_base)

    new_cache = None
    if cache is not None:                      # decode: S == 1
        ck, cv = update_cache(cache["k"], cache["v"], k, v, cur_pos)
        new_cache = {"k": ck, "v": cv}
        out = decode_attention(q, ck, cv, cur_pos, window=window,
                               attn_softcap=cfg.attn_softcap)
    elif kv_override is not None:
        out = flash_attention(q, k, v, causal=False, window=None,
                              attn_softcap=cfg.attn_softcap)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=cfg.attn_softcap)

    proj = torch.einsum("bshk,hkd->bsd", out, p.wo.to(out.dtype))
    return proj, new_cache


__all__ = ["Attention", "NEG_INF", "attention_layer",
           "decode_attention", "flash_attention", "init_attention",
           "update_cache"]
