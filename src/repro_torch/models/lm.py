"""LM assembly: a decoder of global ("g") and sliding-window ("l") attention
blocks with the dense gated MLP.

The port of `repro.models.lm` for the decoder-only attention
architectures. `LM` is an `nn.Module` with one `Block` per layer in a
`ModuleList`; layer ``i`` has kind ``cfg.pattern[i % P]``. The JAX package
stacks each pattern position over the ``⌊L/P⌋`` periods and scans them,
with the ``L mod P`` remainder layers as unstacked "tail" params;
`repro_torch.models.convert` maps between the two layouts.

The functions of the JAX package keep their names (`lm_init`,
`block_apply`, `forward_hidden`, `lm_loss`, `init_decode_states`,
`decode_step`); their ``params`` argument is an `LM`. The kinds "r"
(RG-LRU), "w" (RWKV6) and "b" (encoder), the MoE, the encoder-decoder
and ``remat="full"`` are not ported yet (ROADMAP queue 1, item 2b) and
raise `NotImplementedError`. The mesh sharding constraints of the JAX package
(``constrain_act``) have no counterpart on one card.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.compat import resolve_device
from .attention import Attention, _param, attention_layer
from .config import ModelConfig
from .ffn import MLP, mlp_layer
from .layers import (COMPUTE_DTYPE, chunked_softmax_xent, embed,
                     logits_from_embedding, rms_norm)

PORTED_KINDS = ("g", "l")


def check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what this port does not run yet."""
    missing = sorted(set(cfg.pattern) - set(PORTED_KINDS))
    what = [f"layer kinds {missing}"] if missing else []
    if cfg.is_moe:
        what.append("the MoE")
    if cfg.is_encdec:
        what.append("the encoder-decoder")
    if cfg.remat != "none":
        what.append(f"remat={cfg.remat!r}")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported yet (ROADMAP queue 1, "
            f"item 2b); the port runs the kinds {PORTED_KINDS} with the "
            f"dense MLP")


# --------------------------------------------------------------------------
# modules and init
# --------------------------------------------------------------------------
class Block(nn.Module):
    """One pre-norm (optionally sandwich) block of kind "g" or "l"."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.norm1 = _param((d,), init="zeros", device=device)
        self.norm2 = _param((d,), init="zeros", device=device)
        if cfg.sandwich_norm:
            self.post1 = _param((d,), init="zeros", device=device)
            self.post2 = _param((d,), init="zeros", device=device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


class LM(nn.Module):
    """The decoder: embedding (tied unembedding), blocks, final norm.

    Parameters are created uninitialised; `lm_init` draws them, and
    `repro_torch.models.convert.params_from_jax` loads the JAX package's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        P = len(cfg.pattern)
        dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
            else torch.float32
        self.embed = _param((cfg.vocab_size, cfg.d_model),
                            scale=cfg.d_model ** -0.5, device=device,
                            dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % P], device)
            for i in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), init="zeros", device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter by its init rule (`repro.models.sharding.
    ParamCollector`'s: normal × scale, zeros for norms), in
    `named_parameters` order, from `generator`. Normals are drawn on the
    generator's device and copied to the parameter's."""
    for _, p in model.named_parameters():
        init, scale = p.init_rule
        if init == "zeros":
            p.zero_()
        else:
            val = torch.randn(p.shape, generator=generator,
                              device=generator.device, dtype=p.dtype)
            p.copy_(val * scale)


def lm_init(cfg: ModelConfig, *, seed: int = 0, generator=None,
            device="cuda") -> LM:
    """A freshly initialised `LM` on `device`, drawn from `generator` (by
    default a generator on `device` seeded with `seed`). The JAX package's
    ``lm_init`` also returns the logical-axes tree of its mesh sharding,
    which has no counterpart on one card."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    reset_parameters(model, generator)
    return model


# --------------------------------------------------------------------------
# one block
# --------------------------------------------------------------------------
def block_apply(bp: Block, cfg: ModelConfig, kind: str, x, *, state=None,
                cur_pos=None):
    """Pre-norm (optionally sandwich) block. Returns (x, new_state, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, bp.norm1, cfg.norm_eps)
    tstate = None if state is None else state.get("t")
    out, new_t = attention_layer(bp.attn, cfg, h, is_local=(kind == "l"),
                                 cache=tstate, cur_pos=cur_pos, causal=True)
    if cfg.sandwich_norm:
        out = rms_norm(out, bp.post1, cfg.norm_eps)
    x = x + out

    h = rms_norm(x, bp.norm2, cfg.norm_eps)
    out = mlp_layer(bp.mlp, cfg, h)
    if cfg.sandwich_norm:
        out = rms_norm(out, bp.post2, cfg.norm_eps)
    x = x + out
    new_state = None if state is None else {"t": new_t}
    return x, new_state, aux


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------
def forward_hidden(params: LM, cfg: ModelConfig, tokens=None, embeds=None,
                   *, states=None, cur_pos=None):
    """Decoder trunk → hidden [B, S, d]. Returns (hidden, new_states, aux).

    `states` is `init_decode_states`'s list, one entry per layer."""
    if embeds is None:
        x = embed(tokens, params.embed)
    else:
        x = embeds.to(COMPUTE_DTYPE)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states = None if states is None else []
    for i, bp in enumerate(params.blocks):
        st = None if states is None else states[i]
        x, ns, a = block_apply(bp, cfg, bp.kind, x, state=st,
                               cur_pos=cur_pos)
        aux_total = aux_total + a
        if new_states is not None:
            new_states.append(ns)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, new_states, aux_total


# --------------------------------------------------------------------------
# losses / serving entry points
# --------------------------------------------------------------------------
def lm_loss(params: LM, cfg: ModelConfig, batch: dict):
    """batch: {"tokens": [B, S+1] integer tensor} (+ "embeds" [B, S, d]
    for stub frontends, "loss_mask" [B, S] to drop targets — the
    contamination gate's mask policy). Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    embeds = batch.get("embeds")
    hidden, _, aux = forward_hidden(
        params, cfg, tokens=None if embeds is not None else inputs,
        embeds=embeds)
    loss, wt = chunked_softmax_xent(
        hidden, params.embed, targets, mask=batch.get("loss_mask"),
        cap=cfg.logit_softcap)
    total = loss + 0.01 * aux
    return total, {"xent": loss, "aux": aux, "tokens": wt}


def init_decode_states(cfg: ModelConfig, B: int, cache_len: int, *,
                       device="cuda") -> list:
    """Per-layer decode state: ``{"t": {"k", "v"}}`` ring buffers of
    ``cache_len`` positions for a global layer and ``min(window,
    cache_len)`` for a local one, bf16 zeros."""
    check_ported(cfg)
    dev = resolve_device(device)
    P = len(cfg.pattern)
    states = []
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % P]
        C = cache_len if kind == "g" else min(cfg.window, cache_len)
        shape = (B, C, cfg.n_kv_heads, cfg.hd)
        states.append({"t": {
            "k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev)}})
    return states


def decode_step(params: LM, cfg: ModelConfig, token, states, cur_pos: int):
    """token [B, 1] integer; cur_pos — absolute position (an int).
    Returns (logits [B, 1, V] float32, new_states); the caches of
    `states` are written in place."""
    hidden, new_states, _ = forward_hidden(
        params, cfg, tokens=token, states=states, cur_pos=cur_pos)
    logits = logits_from_embedding(hidden, params.embed,
                                   cap=cfg.logit_softcap)
    return logits, new_states


def param_count(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


__all__ = ["Block", "LM", "PORTED_KINDS", "block_apply", "check_ported",
           "decode_step", "forward_hidden", "init_decode_states", "lm_init",
           "lm_loss", "param_count", "reset_parameters"]
