"""Feed-forward layers: the dense gated MLP.

The port of the dense half of `repro.models.ffn`: ``act(x·wg) * (x·wu)``
then ``·wd``, every product bf16 into bf16. The JAX package's MoE (a
capacity-based router with expert parallelism over a mesh axis) is not
ported yet (ROADMAP queue 1, item 2b); its entry points raise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .attention import _param
from .layers import COMPUTE_DTYPE, activation

_MOE_TODO = ("the MoE feed-forward is not ported yet (ROADMAP queue 1, "
             "item 2b)")


class MLP(nn.Module):
    """The parameters of one dense gated MLP (`init_mlp`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        init_mlp(self, cfg, device)


def init_mlp(mod: nn.Module, cfg, device=None) -> None:
    mod.wg = _param((cfg.d_model, cfg.d_ff), device=device)
    mod.wu = _param((cfg.d_model, cfg.d_ff), device=device)
    mod.wd = _param((cfg.d_ff, cfg.d_model),
                    scale=0.02 / np.sqrt(2 * cfg.n_layers), device=device)


def mlp_layer(p, cfg, x):
    act = activation(cfg.act)
    g = torch.matmul(x, p.wg.to(x.dtype))
    u = torch.matmul(x, p.wu.to(x.dtype))
    h = (act(g) * u).to(COMPUTE_DTYPE)
    return torch.matmul(h, p.wd.to(h.dtype))


def init_moe(*args, **kwargs):
    raise NotImplementedError(_MOE_TODO)


def moe_layer(*args, **kwargs):
    raise NotImplementedError(_MOE_TODO)


__all__ = ["MLP", "init_mlp", "init_moe", "mlp_layer", "moe_layer"]
