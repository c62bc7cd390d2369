"""String-keyed registry of suffix-array construction backends.

A backend is a callable ``(x, options) -> suffix array``: `x` is the
normalised text, an int64[n] tensor on the build's device (values ≥ 0,
n ≥ 2); the result is a tensor or a numpy array of the n suffix positions.
`repro_torch.api.build.build_suffix_array` normalises inputs and outputs
once, so backends only implement the algorithm.

==========  ===============================================================
``oracle``  direct suffix sort (`repro_torch.core.oracle`), on the host —
            the ground truth.
``seq``     paper-faithful sequential DC-v, Algorithm 1
            (`repro_torch.core.seq_ref.suffix_array_dcv`), on the host.
``torch``   vectorised single-device DC-v
            (`repro_torch.core.dcv_torch.suffix_array_torch`) on the
            text's device — the default. Honours ``options.sort_impl``.
``bsp``     Algorithm 3 (`repro_torch.bsp.suffix_array.suffix_array_bsp`)
            on ``options.mesh``, a single-controller mesh of p ranks
            (`repro_torch.launch.mesh`); without one, a mesh of one rank
            a device of the text's kind (p = 1 on one card: the
            single-device path). Honours ``options.sort_impl`` (bsp
            names), ``options.pack_keys`` and ``options.counters``.
==========  ===============================================================
"""
from __future__ import annotations

from typing import Callable

from .options import SAOptions

_REGISTRY: dict[str, Callable] = {}


def register_backend(name: str, builder: Callable, *,
                     overwrite: bool = False) -> Callable:
    """Register `builder` under `name`. Returns the builder (decorator-safe)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = builder
    return builder


def get_backend(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown suffix-array backend {name!r}; "
                       f"registered: {registered_backends()}") from None


def registered_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


#: above this length the oracle switches from the O(n² log n) direct sort to
#: the O(n log² n) prefix-doubling oracle.
_ORACLE_NAIVE_MAX = 2048


def _oracle_backend(x, options: SAOptions):
    from ..core.oracle import suffix_array_doubling, suffix_array_naive
    x = x.cpu().numpy()
    if len(x) <= _ORACLE_NAIVE_MAX:
        return suffix_array_naive(x)
    return suffix_array_doubling(x)


def _seq_backend(x, options: SAOptions):
    from ..core.seq_ref import suffix_array_dcv
    kw = {"v": options.v0, "schedule": options.schedule_fn,
          "stats": options.stats}
    if options.base_threshold is not None:
        kw["base_threshold"] = options.base_threshold
    return suffix_array_dcv(x.cpu().numpy(), **kw)


def _torch_backend(x, options: SAOptions):
    from ..core.dcv_torch import suffix_array_torch
    return suffix_array_torch(
        x, v=options.v0, schedule=options.schedule_fn,
        base_threshold=options.base_threshold, sort_impl=options.sort_impl,
        device=x.device)


def _bsp_backend(x, options: SAOptions):
    from ..bsp.counters import NULL_COUNTERS
    from ..bsp.suffix_array import suffix_array_bsp
    mesh = options.mesh
    if mesh is None:
        from ..launch.mesh import make_sa_mesh
        mesh = make_sa_mesh(axis=options.axis, device=x.device)
    return suffix_array_bsp(
        x, mesh, axis=options.axis, v=options.v0,
        schedule=options.schedule_fn, base_threshold=options.base_threshold,
        counters=options.counters or NULL_COUNTERS,
        pack_keys=options.pack_keys, sort_impl=options.sort_impl)


register_backend("oracle", _oracle_backend)
register_backend("seq", _seq_backend)
register_backend("torch", _torch_backend)
register_backend("bsp", _bsp_backend)
