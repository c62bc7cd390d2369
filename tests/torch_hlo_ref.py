"""The train-step FLOPs that `tests/test_torch_hlo_*.py` compare: the JAX
package's (`repro.launch.hlo_stats` of the compiled step's optimised HLO,
on one CPU device and no mesh) and the port's (`repro_torch.launch.
op_stats` on ``meta``), at ``smoke()`` widths with ``remat="full"``.

The JAX package wraps each flash attention in ``jax.checkpoint`` (a
memory policy: the backward recomputes the score blocks); the port's
attention keeps its blocks (`repro_torch.models.attention`). Inside a
period that is rematerialised anyway XLA folds that recompute into the
period's; where it does not (an encoder layer, which is not
rematerialised, and some MoE and cross-attention periods), the HLO holds
one more forward of those attention products than the port runs. So the
step is compared twice: as it is (the gap at least 0 and at most one
forward of the port's attention products) and with that policy taken
off (within 0.1%).
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.attention as jattention
from repro.launch.hlo_stats import hlo_stats
from repro.launch.specs import abstract_train_state, default_train_config
from repro.train.train_step import make_train_step
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_stats
from repro_torch.models import attention, lm
from repro_torch.models.config import ShapeConfig

B, S = 2, 64
REL = 1e-3


def _no_flash_checkpoint(fn, *args, **kwargs):
    """``jax.checkpoint`` but for the JAX package's flash attention."""
    if isinstance(fn, functools.partial) and \
            fn.func is jattention.flash_attention:
        return fn
    return _checkpoint(fn, *args, **kwargs)


_checkpoint = jax.checkpoint


def reference_flops(arch: str, flash_checkpoint: bool = True) -> float:
    cfg = jconfigs.get_config(arch).smoke().replace(remat="full")
    tcfg = default_train_config(cfg)
    state, _ = abstract_train_state(cfg, tcfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S + 1), jnp.int32)}
    if cfg.is_encdec:
        batch["enc_embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.enc_seq, cfg.d_model), jnp.float32)
    with mock.patch.object(jattention.jax, "checkpoint",
                           _checkpoint if flash_checkpoint
                           else _no_flash_checkpoint):
        hlo = jax.jit(make_train_step(cfg, tcfg)).lower(
            state, batch).compile().as_text()
    return hlo_stats(hlo)["flops"]


def port_step(arch: str):
    cfg = get_config(arch).smoke().replace(remat="full")
    return cfg, dryrun.step_cell(cfg, ShapeConfig("t", S, B, "train"),
                                 {"data": 1, "model": 1})


def port_flops(arch: str) -> int:
    _, (fn, args, _) = port_step(arch)
    return op_stats.count(fn, *args)["flops"]


def port_attention_forward_flops(arch: str) -> int:
    """The FLOPs of one forward of every flash attention of the step."""
    cfg, (_, (state, batch), _) = port_step(arch)
    flash = attention.flash_attention
    total = [0]

    def counted(*args, **kwargs):
        with op_stats.OpCounter() as c:
            out = flash(*args, **kwargs)
        total[0] += c.flops
        return out
    with mock.patch.object(attention, "flash_attention", counted):
        lm.lm_loss(state["params"], cfg, batch)
    return total[0]
