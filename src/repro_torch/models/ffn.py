"""Feed-forward layers: the dense gated MLP and the sort-free
capacity-based MoE (Switch-style capacity-factor semantics).

The port of `repro.models.ffn`. The dense MLP: ``act(x·wg) * (x·wu)``
then ``·wd``, every product bf16 into bf16. The MoE: the JAX package's
single-shard body (`_moe_local` with ``tp=1``), which is what its
`moe_layer` runs without a mesh axis ``model`` larger than 1: top-k of
the router's softmax with renormalised gates, the Switch aux loss, two
capacity stages (per destination shard, then per expert) placed by
`repro_torch.bsp.within_group_index`, batched expert products and the
symmetric return path. The JAX package's ``.at[...].set(mode="drop")``
writes are writes into one extra trash row that is sliced off.

The expert parallelism of the JAX package (`shard_map` with one
``all_to_all`` pair over the ``model`` axis) and its small-S decode body
(`_moe_decode_local`, experts sliced and the outputs summed over the
axis) run only under such a mesh; they have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..bsp.primitives import within_group_index
from .attention import _param
from .layers import COMPUTE_DTYPE, activation, product_f32


# --------------------------------------------------------------------------
# dense gated MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    """The parameters of one dense gated MLP (`init_mlp`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_mlp(self, cfg, device)


def init_mlp(mod: nn.Module, cfg, device=None) -> None:
    mod.wg = _param((cfg.d_model, cfg.d_ff), ("embed_fsdp", "mlp"),
                    device=device)
    mod.wu = _param((cfg.d_model, cfg.d_ff), ("embed_fsdp", "mlp"),
                    device=device)
    mod.wd = _param((cfg.d_ff, cfg.d_model), ("mlp", "embed_fsdp"),
                    scale=0.02 / np.sqrt(2 * cfg.n_layers), device=device)


def mlp_layer(p, cfg, x):
    act = activation(cfg.act)
    g = torch.matmul(x, p.wg.to(x.dtype))
    u = torch.matmul(x, p.wu.to(x.dtype))
    h = (act(g) * u).to(COMPUTE_DTYPE)
    return torch.matmul(h, p.wd.to(h.dtype))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
class MoE(nn.Module):
    """The parameters of one MoE layer (`init_moe`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_moe(self, cfg, device)


def init_moe(mod: nn.Module, cfg, device=None) -> None:
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    mod.router = _param((d, E), ("embed", None), device=device)
    mod.wg = _param((E, d, ff), ("experts", "embed_fsdp", "expert_mlp"),
                    device=device)
    mod.wu = _param((E, d, ff), ("experts", "embed_fsdp", "expert_mlp"),
                    device=device)
    mod.wd = _param((E, ff, d), ("experts", "expert_mlp", "embed_fsdp"),
                    scale=0.02 / np.sqrt(2 * cfg.n_layers), device=device)


class Routing(NamedTuple):
    """Where each of the T·k token-expert assignments goes (one shard).

    ``slot``/``keep``: its arrival slot and whether it is within the
    first capacity ``cap``; ``eid``: the expert of each of the ``cap``
    arrival slots (-1 where empty); ``eslot``/``ekeep``: that arrival's
    slot in its expert's buffer and whether it is within ``cap_e``."""

    ids: torch.Tensor           # [T, k] expert ids
    gate: torch.Tensor          # [T, k] renormalised gates, float32
    aux: torch.Tensor           # Switch load-balance loss, float32
    slot: torch.Tensor          # [T·k] int32
    keep: torch.Tensor          # [T·k] bool
    eid: torch.Tensor           # [cap] int32
    eslot: torch.Tensor         # [cap] int32
    ekeep: torch.Tensor         # [cap] bool
    cap: int
    cap_e: int


def _set_rows(n: int, index, values, fill):
    """A [n, ...] buffer of `fill` with ``values`` written at rows
    ``index``, where a row index of ``n`` is dropped (the JAX package's
    ``.at[index].set(values, mode="drop")``: the writes land in one trash
    row that is sliced off)."""
    buf = values.new_full((n + 1,) + tuple(values.shape[1:]), fill)
    return buf.index_put((index,), values)[:n]


def moe_route(logits, cfg) -> Routing:
    """Top-k routing and both capacity stages from float32 router
    logits [T, E] (`_moe_local` of the JAX package, ``tp=1``)."""
    T = logits.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)                # [T, k]
    gate = gate / torch.clamp(torch.sum(gate, -1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch): E · Σ_e f_e · P_e
    me_frac = torch.mean(torch.sum(F.one_hot(ids, E).float(), dim=1), dim=0)
    pr_frac = torch.mean(probs, dim=0)
    aux = E * torch.sum(me_frac * pr_frac)

    # one shard (the reference's tp = 1): every assignment's owner is
    # shard 0, and the capacities are the reference's floats at tp = 1
    ids_f = ids.reshape(-1)
    owner = ids_f // E
    valid = torch.ones_like(ids_f, dtype=torch.bool)
    cap = int(cfg.capacity_factor * T * k) + 8
    slot = within_group_index(owner, valid)
    keep = slot < cap
    arrival = torch.where(keep, owner * cap + slot, cap).long()
    eid = _set_rows(cap, arrival, (ids_f % E).to(torch.int32), -1)

    ev = eid >= 0
    cap_e = int(cfg.capacity_factor * T * k / E) + 8
    eslot = within_group_index(eid, ev)
    ekeep = ev & (eslot < cap_e)
    return Routing(ids, gate, aux, slot, keep, eid, eslot, ekeep, cap, cap_e)


def _moe_local(x, wr, wg, wu, wd, *, cfg):
    """The single-shard MoE body. x [T, d]; wg/wu [E, d, ff], wd
    [E, ff, d]. Returns ([T, d] bf16, aux float32)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    act = activation(cfg.act)
    # router logits: a float32 product of the operands in x's type
    rt = moe_route(product_f32("td,de->te", x, wr), cfg)
    gate_f = rt.gate.reshape(-1)
    src_f = torch.repeat_interleave(torch.arange(T, device=x.device), k)
    arrival = torch.where(rt.keep, rt.slot, rt.cap).long()
    toks = _set_rows(rt.cap, arrival, x.to(COMPUTE_DTYPE)[src_f], 0)

    R, cap_e = rt.cap, rt.cap_e
    e_pos = torch.where(rt.ekeep, rt.eid.long() * cap_e + rt.eslot,
                        E * cap_e)
    ebuf = _set_rows(E * cap_e, e_pos, toks, 0).reshape(E, cap_e, d)
    rmap = _set_rows(E * cap_e, e_pos,
                     torch.arange(R, dtype=torch.int64, device=x.device), -1)

    g = product_f32("ecd,edf->ecf", ebuf, wg)
    u = product_f32("ecd,edf->ecf", ebuf, wu)
    h = (act(g) * u).to(COMPUTE_DTYPE)
    y = product_f32("ecf,efd->ecd", h, wd).to(COMPUTE_DTYPE)

    # the return path: results back in their arrival slots, then to the
    # assignments; the dropped ones read 0
    rix = torch.where(rmap >= 0, rmap, R)
    y_flat = _set_rows(R, rix, y.reshape(-1, d), 0)
    got = y_flat[torch.clamp(rt.slot.long(), max=R - 1)]     # [T·k, d]
    got = torch.where(rt.keep[:, None], got, 0)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, src_f, got.float() * gate_f[:, None])
    return out.to(COMPUTE_DTYPE), rt.aux


def moe_layer(p, cfg, x):
    """x [B, S, d] → ([B, S, d], aux): the JAX package's `moe_layer`
    without a mesh (its single-shard branch)."""
    B, S, d = x.shape
    out, aux = _moe_local(x.reshape(B * S, d), p.router, p.wg, p.wu, p.wd,
                          cfg=cfg)
    return out.reshape(B, S, d), aux


__all__ = ["MLP", "MoE", "Routing", "init_mlp", "init_moe", "mlp_layer",
           "moe_layer", "moe_route"]
