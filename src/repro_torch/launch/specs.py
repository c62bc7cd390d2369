"""Input specs and their layout on a production mesh for every
(architecture × input shape) dry-run cell, with nothing allocated.

The port of `repro.launch.specs`. Where the JAX package makes
``ShapeDtypeStruct`` s with a ``NamedSharding``, a spec here is a tensor
on the ``meta`` device (shape and dtype, no storage) with its partition
spec and per-device shape over a mesh's axis sizes
(`repro_torch.launch.mesh.production_mesh_shape`). Parameters are an
`LM` on ``meta``, never drawn (``meta`` has no generator); the optimizer
state is `make_train_state`'s on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models.layers import COMPUTE_DTYPE
from ..models.lm import LM, init_decode_states
from ..models.convert import param_groups
from ..models.sharding import (ShardingRules, logical_to_shard_shape,
                               param_shardings, shard_shape)
from ..train.optim import OptConfig
from ..train.train_step import TrainConfig, make_train_state

META = torch.device("meta")


@dataclass(frozen=True)
class Spec:
    """A tensor on ``meta`` and its layout: the partition spec (an entry a
    dimension) and the per-device shape."""

    tensor: torch.Tensor
    spec: tuple
    shard: tuple

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    @property
    def shard_nbytes(self) -> int:
        return math.prod(self.shard) * self.tensor.element_size()


def spec_of(t: torch.Tensor, spec: tuple, mesh_shape: dict) -> Spec:
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    return Spec(t, spec, shard_shape(tuple(t.shape), spec, mesh_shape))


def dp_axes(mesh_shape: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def walk(tree):
    """The leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from walk(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# params + optimizer state (abstract)
# --------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig) -> LM:
    """The `LM` of `cfg` on ``meta``: every shape, no storage; each
    parameter carries its ``logical_axes``."""
    return LM(cfg, device=META)


def params_shardings(model: LM, mesh_shape: dict,
                     rules: ShardingRules | None = None) -> dict:
    """{name: Spec} of every parameter."""
    params = dict(model.named_parameters())
    return {name: Spec(params[name].detach(), spec, shard)
            for name, (shard, spec)
            in param_shardings(model, mesh_shape, rules).items()}


def opt_state_shardings(model: LM, p_specs: dict, opt_state: dict,
                        opt_name: str, mesh_shape: dict,
                        rules: ShardingRules | None = None) -> dict:
    """The optimizer state's specs from the parameters': AdamW's and
    SGD+momentum's moments as their parameter (a tensor a layer);
    Adafactor's ``f`` by the JAX package's leaves, a stacked leaf laid
    out by its logical axes with the leading ``"layers"`` (ruled None),
    ``vr`` dropping the leaf's last dimension and ``vc`` its second-last,
    each with its spec entry; the step replicated."""
    step = spec_of(opt_state["step"], (), mesh_shape)
    if opt_name in ("adamw", "sgdm"):
        out = {k: {n: spec_of(t, p_specs[n].spec, mesh_shape)
                   for n, t in opt_state[k].items()}
               for k in ("m", "v") if k in opt_state}
        return dict(out, step=step)
    groups = param_groups(model)
    params = dict(model.named_parameters())

    def fac(ref, leaf):
        names, stacked = groups[ref]
        spec = p_specs[names[0]].spec
        if stacked:
            p = params[names[0]]
            _, spec = logical_to_shard_shape(
                (len(names),) + tuple(p.shape),
                ("layers",) + tuple(p.logical_axes), mesh_shape, rules)
        if "vr" in leaf:
            return {"vr": spec_of(leaf["vr"], spec[:-1], mesh_shape),
                    "vc": spec_of(leaf["vc"], spec[:-2] + spec[-1:],
                                  mesh_shape)}
        return {"v": spec_of(leaf["v"], spec, mesh_shape)}

    return {"f": {ref: fac(ref, leaf)
                  for ref, leaf in opt_state["f"].items()},
            "step": step}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """`make_train_state` of the abstract params: every tensor on
    ``meta``."""
    return make_train_state(abstract_params(cfg), tcfg)


def train_state_shardings(tcfg: TrainConfig, state: dict, mesh_shape: dict,
                          rules: ShardingRules | None = None) -> dict:
    p_specs = params_shardings(state["params"], mesh_shape, rules)
    out = {"params": p_specs,
           "opt": opt_state_shardings(state["params"], p_specs, state["opt"],
                                      tcfg.opt.name, mesh_shape, rules)}
    if "ef_error" in state:
        out["ef_error"] = {n: spec_of(t, p_specs[n].spec, mesh_shape)
                           for n, t in state["ef_error"].items()}
    return out


# --------------------------------------------------------------------------
# batch / decode-state specs
# --------------------------------------------------------------------------
def _enc(cfg: ModelConfig, B: int, dtype, mesh_shape: dict, dp) -> Spec:
    t = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=dtype, device=META)
    return spec_of(t, (dp, None, None), mesh_shape)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_shape: dict) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dp = dp_axes(mesh_shape)
    toks = torch.empty((B, S + 1), dtype=torch.int32, device=META)
    batch = {"tokens": spec_of(toks, (dp, None), mesh_shape)}
    if cfg.is_encdec:
        batch["enc_embeds"] = _enc(cfg, B, torch.float32, mesh_shape, dp)
    return batch


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig,
                  mesh_shape: dict) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dp = dp_axes(mesh_shape)
    toks = torch.empty((B, S), dtype=torch.int32, device=META)
    batch = {"tokens": spec_of(toks, (dp, None), mesh_shape)}
    if cfg.is_encdec:
        batch["enc_embeds"] = _enc(cfg, B, torch.float32, mesh_shape, dp)
    return batch


def decode_state_spec(shape: tuple, B: int, mesh_shape: dict,
                      seq_shard: bool) -> tuple:
    """`repro.launch.specs.decode_state_specs`'s per-leaf heuristic on a
    leaf of `shape` in the JAX package's layout (stacked leaves lead with
    the layer axis): batch over the dp axes when B > 1; a KV cache's heads
    over ``model``, or its length where the heads do not divide (and its
    length over ``data`` when B == 1, the long_500k sequence-parallel
    layout); an RWKV state's heads over ``model``."""
    dp = dp_axes(mesh_shape)
    spec = [None] * len(shape)
    bdim = 1 if (len(shape) >= 2 and shape[1] == B) else 0
    if shape[bdim] != B:
        return tuple(spec)
    n_dp = math.prod(mesh_shape[a] for a in dp) if dp else 1
    if not seq_shard and B % max(n_dp, 1) == 0 and dp:
        spec[bdim] = dp
    model = mesh_shape["model"]
    if len(shape) - bdim == 4:                         # B, C, H, hd
        if shape[bdim + 2] % model == 0:
            spec[bdim + 2] = "model"
        elif shape[bdim + 1] % model == 0:
            spec[bdim + 1] = "model"
        if seq_shard and "data" in mesh_shape and \
                spec[bdim + 1] is None and \
                shape[bdim + 1] % mesh_shape["data"] == 0:
            spec[bdim + 1] = "data"
    elif len(shape) - bdim == 3:                       # rwkv S: B, H, hd, hd?
        if shape[bdim + 1] % model == 0:
            spec[bdim + 1] = "model"
    return tuple(spec)


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig,
                       mesh_shape: dict) -> tuple[list, list]:
    """(the decode states on ``meta``, their specs in the same structure).

    Each leaf's layout is the JAX package's heuristic applied to the leaf
    as the JAX package holds it: a layer of the ⌊L/P⌋ periods is a slice
    of a stacked leaf (the heuristic sees ``[⌊L/P⌋, B, ...]``, the layer
    axis replicated), a tail layer is a leaf of its own."""
    B, S = shape.global_batch, shape.seq_len
    states = init_decode_states(cfg, B, cache_len=S, device=META)
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    seq_shard = B == 1

    def one(t, stacked):
        if stacked:
            spec = decode_state_spec((n_full,) + tuple(t.shape), B,
                                     mesh_shape, seq_shard)[1:]
        else:
            spec = decode_state_spec(tuple(t.shape), B, mesh_shape,
                                     seq_shard)
        return spec_of(t, spec, mesh_shape)

    specs = [{part: {k: one(t, i < n_full * P) for k, t in leaves.items()}
              for part, leaves in st.items()}
             for i, st in enumerate(states)]
    return states, specs


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                       mesh_shape: dict) -> dict:
    """The token [B, 1], the position (a 0-d int32, as the JAX package
    passes it; the port's `decode_step` takes it as an int) and, for an
    encoder-decoder, the encoder's output."""
    B = shape.global_batch
    dp = dp_axes(mesh_shape) if B > 1 else None
    out = {"token": spec_of(torch.empty((B, 1), dtype=torch.int32,
                                        device=META), (dp, None), mesh_shape),
           "cur_pos": spec_of(torch.empty((), dtype=torch.int32,
                                          device=META), (), mesh_shape)}
    if cfg.is_encdec:
        out["enc_out"] = _enc(cfg, B, COMPUTE_DTYPE, mesh_shape, dp)
    return out


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    # remat="full" recomputes blocks in backward: activation footprint drops
    # from O(L·B·S·d·intermediates) to O(L·B·S·d) (§Perf iteration 6).
    return TrainConfig(
        opt=OptConfig(name=cfg.optimizer, lr=3e-4),
        schedule=cfg.lr_schedule,
        warmup=2000, total_steps=100_000,
        microbatches=1, remat="none")   # remat lives INSIDE the model
                                           # (per-layer, cfg.remat)


# which cells run (DESIGN §5 applicability table)
LONG_OK = {"gemma2-27b", "gemma3-27b", "gemma3-1b", "recurrentgemma-2b",
           "rwkv6-1.6b"}


def cell_runs(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.name in LONG_OK
    return True


__all__ = ["LONG_OK", "META", "Spec", "abstract_params",
           "abstract_train_state", "cell_runs", "decode_batch_specs",
           "decode_state_spec", "decode_state_specs", "default_train_config",
           "dp_axes", "opt_state_shardings", "params_shardings",
           "prefill_specs", "spec_of", "train_batch_specs",
           "train_state_shardings", "walk"]
