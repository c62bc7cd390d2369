"""Parameters between the JAX package's layout and the port's `LM`.

`repro.models.lm.lm_init` stacks each pattern position over the
periods:
``blocks.l{j}`` leaves have shape ``[⌊L/P⌋, ...]`` and layer ``p·P + j`` is
slice ``p``; the ``L mod P`` remainder layers are the unstacked
``tail.l{j}`` (layer ``⌊L/P⌋·P + j``). An encoder-decoder's encoder layers
are stacked as ``enc.l0`` (layer ``i`` is slice ``i``). The port has one
`Block` per layer (``blocks.{i}``, ``enc.{i}``). `params_from_jax` loads a
nested dict of such arrays (numpy, or anything `numpy.asarray` takes)
into an `LM`; `params_to_jax` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compat import resolve_device
from .config import ModelConfig
from .lm import LM

#: the leaves outside the layers.
_TOP = ("embed", "final_norm", "enc_norm")


def _to_torch(leaf) -> torch.Tensor:
    leaf = np.array(leaf)
    if leaf.dtype.name == "bfloat16":      # ml_dtypes' (JAX's) bf16
        return torch.from_numpy(leaf.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(leaf)


def _to_numpy(p: torch.Tensor) -> np.ndarray:
    """A copy of `p` on the host. numpy has no bf16 of its own: a bf16
    parameter comes back in ml_dtypes' bfloat16 where it is registered
    (JAX registers it), else as its float32 values (exact)."""
    t = p.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(bf16)
    return np.array(t.numpy())


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


def _layer_source(cfg: ModelConfig, stack: str, i: int
                  ) -> tuple[str, int | None]:
    """(the JAX package's subtree of the port's layer ``{stack}.{i}``, its
    slice or None)."""
    if stack == "enc":
        return "enc.l0", i
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    if i < n_full * P:
        p, j = divmod(i, P)
        return f"blocks.l{j}", p
    return f"tail.l{i - n_full * P}", None


def _layers(cfg: ModelConfig):
    yield from (("blocks", i) for i in range(cfg.n_layers))
    yield from (("enc", i) for i in range(cfg.encoder_layers))


def params_from_jax(params_np, cfg: ModelConfig, *, device="cuda") -> LM:
    """An `LM` on `device` holding the JAX package's `lm_init` params
    (a nested dict of arrays)."""
    dev = resolve_device(device)
    flat = _flat(params_np)
    state = {name: flat.pop(name) for name in _TOP if name in flat}
    for stack, i in _layers(cfg):
        src, p = _layer_source(cfg, stack, i)
        for name in [n for n in flat if n.startswith(src + ".")]:
            leaf = np.asarray(flat[name])
            state[f"{stack}.{i}.{name[len(src) + 1:]}"] = \
                leaf[p] if p is not None else leaf
    # a layer's leaf the port lacks fails in load_state_dict; another
    # top-level one fails here
    extra = {n for n in flat
             if not n.startswith(("blocks.", "tail.", "enc."))}
    if extra:
        raise ValueError(f"params the port has no place for: "
                         f"{sorted(extra)}")
    model = LM(cfg, device=dev)
    model.load_state_dict({k: _to_torch(v) for k, v in state.items()},
                          strict=True)
    return model


def params_to_jax(model: LM) -> dict:
    """The JAX package's nested params dict (numpy arrays) of `model`."""
    cfg = model.cfg
    flat = {name: _to_numpy(p) for name, p in model.named_parameters()}
    out = {name: flat.pop(name) for name in _TOP if name in flat}
    stacked: dict = {}
    for name, leaf in flat.items():
        stack, i, rest = name.split(".", 2)
        src, p = _layer_source(cfg, stack, int(i))
        if p is None:
            out[f"{src}.{rest}"] = leaf
        else:
            stacked.setdefault(f"{src}.{rest}", {})[p] = leaf
    out.update({name: np.stack([leaves[p] for p in range(len(leaves))])
                for name, leaves in stacked.items()})
    return _nest(out)


__all__ = ["params_from_jax", "params_to_jax"]
