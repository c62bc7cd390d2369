"""LM assembly: the decoder (+ optional encoder) of every architecture of
the JAX package, through ModelConfig.pattern:

  "g" global attention · "l" sliding-window attention · "r" RG-LRU block ·
  "w" RWKV6 time-mix (+ channel-mix MLP) · encoder layers are
  bidirectional ("b"); the MLP is the MoE when ``cfg.is_moe``.

The port of `repro.models.lm`. `LM` is an `nn.Module` with one `Block`
per layer in a `ModuleList`; layer ``i`` has kind ``cfg.pattern[i % P]``.
The JAX package stacks each pattern position over the ``⌊L/P⌋`` periods
and scans them, with the ``L mod P`` remainder layers as unstacked "tail"
params, and stacks the encoder's layers as ``enc.l0``;
`repro_torch.models.convert` maps between the two layouts.

The functions of the JAX package keep their names (`lm_init`,
`block_apply`, `encode`, `forward_hidden`, `lm_loss`,
`init_decode_states`, `decode_step`); their ``params`` argument is an
`LM`. ``cfg.remat == "full"`` checkpoints each pattern period of the
training forward (`torch.utils.checkpoint`), as the JAX package's
``jax.checkpoint`` of its scan body does: a memory policy with the same
values. The mesh sharding constraints of the JAX package
(``constrain_act``) and ``jax.checkpoint``'s ``prevent_cse`` have no
counterpart on one card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.compat import resolve_device
from .attention import Attention, _param, attention_layer
from .config import ModelConfig
from .ffn import MLP, MoE, mlp_layer, moe_layer
from .layers import (COMPUTE_DTYPE, chunked_softmax_xent, embed,
                     logits_from_embedding, product_f32, rms_norm)
from .rglru import RGLRU, init_rglru_state, rglru_layer
from .rwkv6 import (ChannelMix, TimeMix, init_rwkv_state, rwkv_channel_mix,
                    rwkv_time_mix)


# --------------------------------------------------------------------------
# modules and init
# --------------------------------------------------------------------------
class Block(nn.Module):
    """One pre-norm (optionally sandwich) block (`_init_block`): the
    temporal mixer of its kind, cross-attention when `cross`, then the
    channel-mix ("w"), the MoE or the dense MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 cross: bool = False):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.norm1 = _param((d,), ("embed",), init="zeros", device=device)
        self.norm2 = _param((d,), ("embed",), init="zeros", device=device)
        if cfg.sandwich_norm:
            self.post1 = _param((d,), ("embed",), init="zeros",
                                device=device)
            self.post2 = _param((d,), ("embed",), init="zeros",
                                device=device)
        if kind in ("g", "l", "b"):
            self.attn = Attention(cfg, device)
        elif kind == "r":
            self.rnn = RGLRU(cfg, device)
        elif kind == "w":
            self.tmix = TimeMix(cfg, device)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if cross:
            self.norm_x = _param((d,), ("embed",), init="zeros",
                                 device=device)
            self.xattn = Attention(cfg, device)
        if kind == "w":
            self.cmix = ChannelMix(cfg, device)
        elif cfg.is_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class LM(nn.Module):
    """The decoder: embedding (tied unembedding), blocks, final norm; and
    for an encoder-decoder config the encoder's "b" blocks and norm.

    Parameters are created uninitialised; `lm_init` draws them, and
    `repro_torch.models.convert.params_from_jax` loads the JAX package's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        P = len(cfg.pattern)
        dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
            else torch.float32
        self.embed = _param((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed"), scale=cfg.d_model ** -0.5,
                            device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % P], device, cross=cfg.is_encdec)
            for i in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), ("embed",), init="zeros",
                                 device=device)
        if cfg.is_encdec:
            self.enc = nn.ModuleList(Block(cfg, "b", device)
                                     for _ in range(cfg.encoder_layers))
            self.enc_norm = _param((cfg.d_model,), ("embed",),
                                   init="zeros", device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter by its init rule (`repro.models.sharding.
    ParamCollector`'s: normal × scale, zeros for norms, ones for the
    RG-LRU's Λ), in
    `named_parameters` order, from `generator`. Normals are drawn on the
    generator's device and copied to the parameter's."""
    for _, p in model.named_parameters():
        init, scale = p.init_rule
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        else:
            val = torch.randn(p.shape, generator=generator,
                              device=generator.device, dtype=p.dtype)
            p.copy_(val * scale)


def lm_init(cfg: ModelConfig, *, seed: int = 0, generator=None,
            device="cuda") -> LM:
    """A freshly initialised `LM` on `device`, drawn from `generator` (by
    default a generator on `device` seeded with `seed`). The JAX package's
    ``lm_init`` also returns the logical-axes tree of its mesh sharding;
    here each parameter carries its axes as ``p.logical_axes``
    (`repro_torch.models.sharding.param_shardings` reads them)."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    reset_parameters(model, generator)
    return model


# --------------------------------------------------------------------------
# one block
# --------------------------------------------------------------------------
def _temporal(bp: Block, cfg: ModelConfig, kind: str, x, *, state, cur_pos):
    if kind in ("g", "l", "b"):
        return attention_layer(bp.attn, cfg, x, is_local=(kind == "l"),
                               cache=state, cur_pos=cur_pos,
                               causal=(kind != "b"))
    if kind == "r":
        return rglru_layer(bp.rnn, cfg, x, state=state)
    if kind == "w":
        return rwkv_time_mix(bp.tmix, cfg, x, state=state)
    raise ValueError(kind)


def block_apply(bp: Block, cfg: ModelConfig, kind: str, x, *, state=None,
                cur_pos=None, enc_out=None):
    """Pre-norm (optionally sandwich) block. Returns (x, new_state, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, bp.norm1, cfg.norm_eps)
    tstate = None if state is None else state.get("t")
    out, new_t = _temporal(bp, cfg, kind, h, state=tstate, cur_pos=cur_pos)
    if cfg.sandwich_norm:
        out = rms_norm(out, bp.post1, cfg.norm_eps)
    x = x + out

    if enc_out is not None and hasattr(bp, "xattn"):
        h = rms_norm(x, bp.norm_x, cfg.norm_eps)
        out, _ = attention_layer(bp.xattn, cfg, h, is_local=False,
                                 kv_override=_cross_kv(bp.xattn, enc_out),
                                 causal=False)
        x = x + out

    h = rms_norm(x, bp.norm2, cfg.norm_eps)
    mstate = None if state is None else state.get("m")
    new_m = None
    if kind == "w":
        out, new_m = rwkv_channel_mix(bp.cmix, cfg, h, state=mstate)
    elif cfg.is_moe:
        out, aux = moe_layer(bp.moe, cfg, h)
    else:
        out = mlp_layer(bp.mlp, cfg, h)
    if cfg.sandwich_norm:
        out = rms_norm(out, bp.post2, cfg.norm_eps)
    x = x + out
    new_state = None
    if state is not None:
        new_state = {"t": new_t, "m": new_m} if new_m is not None else \
            {"t": new_t}
    return x, new_state, aux


def _cross_kv(p, enc_out):
    k = product_f32("bsd,dhk->bshk", enc_out, p.wk).to(COMPUTE_DTYPE)
    v = product_f32("bsd,dhk->bshk", enc_out, p.wv).to(COMPUTE_DTYPE)
    return k, v


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------
def _sinusoid(S: int, d: int, device=None):
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                           axis=-1)).to(device, COMPUTE_DTYPE)


def _sinusoid_at(positions, d: int):
    """Sinusoidal embeddings at positions [S] (a tensor) → [S, d]."""
    i = torch.arange(d // 2, dtype=torch.float32,
                     device=positions.device)[None, :]
    ang = positions.float()[:, None] / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(COMPUTE_DTYPE)


def encode(params: LM, cfg: ModelConfig, enc_embeds):
    """Whisper-style encoder over precomputed frame embeddings [B, T, d]."""
    x = enc_embeds.to(COMPUTE_DTYPE) + _sinusoid(
        enc_embeds.shape[1], cfg.d_model, enc_embeds.device)[None]
    for bp in params.enc:
        x, _, _ = block_apply(bp, cfg, "b", x)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _run_blocks(blocks, cfg: ModelConfig, x, enc_out):
    """The training forward of consecutive blocks: (x, their aux sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in blocks:
        x, _, a = block_apply(bp, cfg, bp.kind, x, enc_out=enc_out)
        aux = aux + a
    return x, aux


def forward_hidden(params: LM, cfg: ModelConfig, tokens=None, embeds=None,
                   *, states=None, cur_pos=None, enc_out=None):
    """Decoder trunk → hidden [B, S, d]. Returns (hidden, new_states, aux).

    `states` is `init_decode_states`'s list, one entry per layer."""
    if embeds is None:
        x = embed(tokens, params.embed)
    else:
        x = embeds.to(COMPUTE_DTYPE)
    if cfg.is_encdec:
        start = 0 if cur_pos is None else cur_pos
        positions = start + torch.arange(x.shape[1], device=x.device)
        x = x + _sinusoid_at(positions, cfg.d_model)[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = list(params.blocks)
    first = 0
    if states is None and cfg.remat == "full":
        # per-period remat: the backward recomputes each period's blocks
        # and keeps only the period's input
        P = len(cfg.pattern)
        first = cfg.n_layers // P * P
        for p0 in range(0, first, P):
            x, a = checkpoint(_run_blocks, blocks[p0:p0 + P], cfg, x,
                              enc_out, use_reentrant=False)
            aux_total = aux_total + a
    new_states = None if states is None else []
    for i in range(first, cfg.n_layers):
        bp = blocks[i]
        st = None if states is None else states[i]
        x, ns, a = block_apply(bp, cfg, bp.kind, x, state=st,
                               cur_pos=cur_pos, enc_out=enc_out)
        aux_total = aux_total + a
        if new_states is not None:
            new_states.append(ns)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, new_states, aux_total


# --------------------------------------------------------------------------
# losses / serving entry points
# --------------------------------------------------------------------------
def lm_loss(params: LM, cfg: ModelConfig, batch: dict):
    """batch: {"tokens": [B, S+1] integer tensor} (+ "enc_embeds"
    [B, T, d] for enc-dec, "embeds" [B, S, d] for stub frontends,
    "loss_mask" [B, S] to drop targets — the contamination gate's mask
    policy). Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["enc_embeds"])
    embeds = batch.get("embeds")
    hidden, _, aux = forward_hidden(
        params, cfg, tokens=None if embeds is not None else inputs,
        embeds=embeds, enc_out=enc_out)
    loss, wt = chunked_softmax_xent(
        hidden, params.embed, targets, mask=batch.get("loss_mask"),
        cap=cfg.logit_softcap)
    total = loss + 0.01 * aux
    return total, {"xent": loss, "aux": aux, "tokens": wt}


def init_decode_states(cfg: ModelConfig, B: int, cache_len: int, *,
                       device="cuda") -> list:
    """Per-layer decode state, one entry per decoder layer: ``{"t":
    {"k", "v"}}`` bf16 ring buffers of ``cache_len`` positions for a
    global layer and ``min(window, cache_len)`` for a local one; ``{"t":
    {"h", "conv"}}`` for an RG-LRU layer; ``{"t": {"x_prev", "S"}, "m":
    {"x_prev"}}`` for an RWKV6 layer."""
    dev = resolve_device(device)
    P = len(cfg.pattern)

    def one(kind):
        if kind in ("g", "l", "b"):
            C = min(cfg.window, cache_len) if kind == "l" else cache_len
            shape = (B, C, cfg.n_kv_heads, cfg.hd)
            return {"t": {
                "k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev)}}
        if kind == "r":
            return {"t": init_rglru_state(cfg, B, device=dev)}
        if kind == "w":
            s = init_rwkv_state(cfg, B, device=dev)
            return {"t": s["tm"], "m": s["cm"]}
        raise ValueError(f"unknown layer kind {kind!r}")

    return [one(cfg.pattern[i % P]) for i in range(cfg.n_layers)]


def decode_step(params: LM, cfg: ModelConfig, token, states, cur_pos: int,
                *, enc_out=None):
    """token [B, 1] integer; cur_pos — absolute position (an int).
    Returns (logits [B, 1, V] float32, new_states); the attention caches
    of `states` are written in place, the recurrent states come back
    new."""
    hidden, new_states, _ = forward_hidden(
        params, cfg, tokens=token, states=states, cur_pos=cur_pos,
        enc_out=enc_out)
    logits = logits_from_embedding(hidden, params.embed,
                                   cap=cfg.logit_softcap)
    return logits, new_states


def param_count(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


__all__ = ["Block", "LM", "block_apply", "decode_step", "encode",
           "forward_hidden", "init_decode_states", "lm_init", "lm_loss",
           "param_count", "reset_parameters"]
