"""Parameters and train states between the JAX package's layout and the
port's `LM`.

`repro.models.lm.lm_init` stacks each pattern position over the
periods:
``blocks.l{j}`` leaves have shape ``[⌊L/P⌋, ...]`` and layer ``p·P + j`` is
slice ``p``; the ``L mod P`` remainder layers are the unstacked
``tail.l{j}`` (layer ``⌊L/P⌋·P + j``). An encoder-decoder's encoder layers
are stacked as ``enc.l0`` (layer ``i`` is slice ``i``). The port has one
`Block` per layer (``blocks.{i}``, ``enc.{i}``); `param_groups` names the
port's parameters of each of the JAX package's leaves. `params_from_jax`
loads a nested dict of such arrays (numpy, or anything `numpy.asarray`
takes) into an `LM`; `params_to_jax` is its inverse.

`train_state_to_jax` and `load_train_state_from_jax` do the same for a
whole train state ``{"opt", "params", ["ef_error"]}``
(`repro_torch.train.train_step`): AdamW's ``m``/``v``, SGD+momentum's
``m`` and the error-feedback residuals, which the port keeps a tensor a
layer, are stacked as the parameters are; Adafactor's ``f`` is kept in
the JAX package's layout already, one ``{"vr", "vc"}`` or ``{"v"}`` entry
per leaf; the step is an int32 0-d array. The tree is the one the JAX
package's `make_train_state` gives and its checkpoints hold, host numpy
arrays with a bf16 leaf as its raw bits (`repro_torch.ckpt.checkpoint.
BF16_BITS`), so a checkpoint of either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ckpt.checkpoint import BF16_BITS, to_host
from ..core.compat import resolve_device
from .config import ModelConfig
from .lm import LM


def _to_torch(leaf) -> torch.Tensor:
    """A tensor of `leaf` (a tensor, or an array numpy takes; bf16 as
    ml_dtypes' (JAX's) bfloat16 or as its bits)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    leaf = np.asarray(leaf)
    if not leaf.flags.writeable:
        leaf = leaf.copy()
    if leaf.dtype == BF16_BITS or leaf.dtype.name == "bfloat16":
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


def _flat(tree) -> dict:
    """{dotted name: leaf} of a nested dict, walked with an explicit
    stack."""
    out, stack = {}, [("", tree)]
    while stack:
        prefix, node = stack.pop()
        for key, sub in node.items():
            name = f"{prefix}{key}"
            if isinstance(sub, dict):
                stack.append((name + ".", sub))
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


def _ref_name(cfg: ModelConfig, name: str) -> tuple[str, int | None]:
    """(the JAX package's leaf of the port's parameter `name`, its slice
    there or None)."""
    if not name.startswith(("blocks.", "enc.")):
        return name, None
    stack, i, rest = name.split(".", 2)
    src, p = _layer_source(cfg, stack, int(i))
    return f"{src}.{rest}", p


def param_groups(model: LM) -> dict[str, tuple[list[str], bool]]:
    """{the JAX package's leaf name: (the port's parameter names it
    holds, slice by slice; whether it is stacked)}, in `named_parameters`
    order."""
    out: dict = {}
    for name, _ in model.named_parameters():
        ref, p = _ref_name(model.cfg, name)
        out.setdefault(ref, ([], p is not None))[0].append(name)
    return out


def _stacked(parts: list[np.ndarray], stacked: bool) -> np.ndarray:
    if not stacked:
        return parts[0]
    out = np.empty((len(parts),) + parts[0].shape, parts[0].dtype)
    for p, part in enumerate(parts):
        out[p] = part
    return out


def _to_jax_layout(groups: dict, tensors: dict, host) -> dict:
    """The JAX package's nested tree of `tensors` (keyed by the port's
    parameter names), each slice through `host`."""
    return _nest({ref: _stacked([host(tensors[n]) for n in names], stacked)
                  for ref, (names, stacked) in groups.items()})


def _copy(dst: torch.Tensor, src, name: str) -> None:
    """``dst.copy_(src)``, which must not broadcast."""
    src = _to_torch(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: got shape {list(src.shape)}, the port "
                         f"holds {list(dst.shape)}")
    dst.copy_(src)


def _from_jax_layout(groups: dict, tensors: dict, tree: dict,
                     what: str) -> None:
    """Copy the JAX package's nested `tree` into `tensors` (keyed by the
    port's parameter names) in place, slice by slice."""
    flat = _flat(tree)
    for ref, (names, stacked) in groups.items():
        if ref not in flat:
            raise ValueError(f"{what}: no leaf {ref!r}")
        leaf = _to_torch(flat.pop(ref))
        for p, name in enumerate(names):
            _copy(tensors[name], leaf[p] if stacked else leaf,
                  f"{what} {ref}")
    if flat:
        raise ValueError(f"{what}: leaves the port has no place for: "
                         f"{sorted(flat)}")


def params_from_jax(params_np, cfg: ModelConfig, *, device="cuda") -> LM:
    """An `LM` on `device` holding the JAX package's `lm_init` params
    (a nested dict of arrays)."""
    model = LM(cfg, device=resolve_device(device))
    with torch.no_grad():
        _from_jax_layout(param_groups(model), dict(model.named_parameters()),
                         params_np, "params")
    return model


def params_to_jax(model: LM) -> dict:
    """The JAX package's nested params dict (numpy arrays) of `model`."""
    return _to_jax_layout(param_groups(model),
                          dict(model.named_parameters()), _to_numpy)


def train_state_to_jax(state: dict) -> dict:
    """The JAX package's train-state tree of `state` (host numpy copies,
    bf16 as its bits): what that package's `make_train_state` gives and
    its checkpoints hold."""
    model = state["params"]
    groups = param_groups(model)
    opt = {}
    for key, sub in state["opt"].items():
        if key == "step":
            opt[key] = to_host(sub)
        elif key == "f":            # Adafactor: the JAX layout already
            opt[key] = _nest({ref: {k: to_host(t) for k, t in leaf.items()}
                              for ref, leaf in sub.items()})
        else:
            opt[key] = _to_jax_layout(groups, sub, to_host)
    out = {"opt": opt, "params": _to_jax_layout(
        groups, dict(model.named_parameters()), to_host)}
    if "ef_error" in state:
        out["ef_error"] = _to_jax_layout(groups, state["ef_error"], to_host)
    return out


def load_train_state_from_jax(state: dict, tree: dict) -> dict:
    """Copy the JAX package's train-state tree (`train_state_to_jax`'s
    structure; numpy arrays, bf16 as bits or as ml_dtypes' bfloat16, or
    tensors) into `state` in place, on its device; returns `state`. Every
    leaf must have the shape the state holds."""
    model = state["params"]
    groups = param_groups(model)
    with torch.no_grad():
        _from_jax_layout(groups, dict(model.named_parameters()),
                         tree["params"], "params")
        for key, sub in state["opt"].items():
            if key == "step":
                _copy(sub, tree["opt"]["step"], "opt step")
            elif key == "f":
                flat = _flat(tree["opt"]["f"])
                for ref, leaf in sub.items():
                    for k, t in leaf.items():
                        _copy(t, flat[f"{ref}.{k}"], f"opt f {ref}.{k}")
            else:
                _from_jax_layout(groups, sub, tree["opt"][key], f"opt {key}")
        if "ef_error" in state:
            _from_jax_layout(groups, state["ef_error"], tree["ef_error"],
                             "ef_error")
    return state


__all__ = ["load_train_state_from_jax", "param_groups", "params_from_jax",
           "params_to_jax", "train_state_to_jax"]
