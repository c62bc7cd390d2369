"""Parameters between the JAX package's layout and the port's `LM`.

`repro.models.lm.lm_init` stacks each pattern position over the
periods:
``blocks.l{j}`` leaves have shape ``[⌊L/P⌋, ...]`` and layer ``p·P + j`` is
slice ``p``; the ``L mod P`` remainder layers are the unstacked
``tail.l{j}`` (layer ``⌊L/P⌋·P + j``). The port has one `Block` per layer.
`params_from_jax` loads a nested dict of such arrays (numpy, or anything
`numpy.asarray` takes) into an `LM`; `params_to_jax` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compat import resolve_device
from .config import ModelConfig
from .lm import LM


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, dict):
            out.update(_flat(sub, name + "."))
        else:
            out[name] = sub
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[last] = leaf
    return out


def _layer_source(cfg: ModelConfig, i: int) -> tuple[str, int | None]:
    """(the JAX package's subtree of layer i, its slice or None)."""
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    if i < n_full * P:
        p, j = divmod(i, P)
        return f"blocks.l{j}", p
    return f"tail.l{i - n_full * P}", None


def params_from_jax(params_np, cfg: ModelConfig, *, device="cuda") -> LM:
    """An `LM` on `device` holding the JAX package's `lm_init` params
    (a nested dict of arrays)."""
    dev = resolve_device(device)
    flat = _flat(params_np)
    state = {"embed": flat.pop("embed"), "final_norm": flat.pop("final_norm")}
    for i in range(cfg.n_layers):
        src, p = _layer_source(cfg, i)
        for name in [n for n in flat if n.startswith(src + ".")]:
            leaf = np.asarray(flat[name])
            state[f"blocks.{i}.{name[len(src) + 1:]}"] = \
                leaf[p] if p is not None else leaf
    # a layer's leaf the port lacks fails in load_state_dict; a top-level
    # one (an encoder's) fails here
    extra = {n for n in flat if not n.startswith(("blocks.", "tail."))}
    if extra:
        raise ValueError(f"params the port has no place for: "
                         f"{sorted(extra)}")
    model = LM(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return model


def params_to_jax(model: LM) -> dict:
    """The JAX package's nested params dict (numpy arrays) of `model`."""
    cfg = model.cfg
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    # copies, not views of the parameters' storage
    flat = {name: np.array(p.detach().cpu().numpy())
            for name, p in model.named_parameters()}
    out = {"embed": flat.pop("embed"), "final_norm": flat.pop("final_norm")}
    stacked: dict = {}
    for name, leaf in flat.items():
        _, i, rest = name.split(".", 2)
        src, p = _layer_source(cfg, int(i))
        if p is None:
            out[f"{src}.{rest}"] = leaf
        else:
            stacked.setdefault(f"{src}.{rest}", [None] * n_full)[p] = leaf
    out.update({name: np.stack(leaves) for name, leaves in stacked.items()})
    return _nest(out)


__all__ = ["params_from_jax", "params_to_jax"]
