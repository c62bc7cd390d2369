"""`build_suffix_array` — the one entry point for suffix-array construction.

Validation, dtype normalisation and trivial-input fast paths live here so
every backend sees the same contract (an int64 1-D tensor on the build's
device, values in [0, 2³¹), n ≥ 2) and every caller gets the same result
type: an int32[n] tensor on that device, a permutation of range(n).

This module also owns the **builder cache**: one entry per
``(resolved plan, device, bucketed length)``, where "resolved" means backend
and sort_impl are concrete ("auto" and its resolution share an entry).
Plans with ``options.cache=True`` run the torch backend with bucketed
padding (`repro_torch.core.dcv_torch.pad_bucket`), so all lengths inside
one bucket reach the same level shapes. Its hit/miss counters say whether
a build landed on a configuration seen before;
`builder_cache_stats()` / `clear_builder_cache()` expose them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.compat import resolve_device, resolve_sort_impl
from ..core.dcv_torch import pad_bucket
from ..trace import span
from .options import SAOptions
from .registry import get_backend

#: (backend, v0, schedule, base_threshold, resolved sort_impl, device,
#: n_bucket) → (builder fn, resolved sort_impl).
_BUILDER_CACHE: dict[tuple, tuple[Callable, str]] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def builder_cache_stats() -> dict:
    """Snapshot of the builder cache: entries / hits / misses."""
    return {"entries": len(_BUILDER_CACHE), **_CACHE_STATS}


def clear_builder_cache() -> None:
    """Drop all builder-cache entries and reset the hit/miss counters."""
    _BUILDER_CACHE.clear()
    _CACHE_STATS["hits"] = 0
    _CACHE_STATS["misses"] = 0


def _resolved_impl(opts: SAOptions, backend: str,
                   device: torch.device) -> str:
    """Concrete sort_impl for this plan: the torch backend resolves by
    device (`core.compat.resolve_sort_impl`), the bsp backend by
    `bsp.psort.resolve_bsp_sort_impl` (imported lazily, so only bsp plans
    load the BSP stack)."""
    if backend == "torch":
        return resolve_sort_impl(opts.sort_impl, device)
    if backend == "bsp":
        from ..bsp.psort import resolve_bsp_sort_impl
        return resolve_bsp_sort_impl(opts.sort_impl, opts.pack_keys)
    return opts.sort_impl


def _cached_builder(opts: SAOptions, device: torch.device,
                    n: int) -> tuple[Callable, SAOptions]:
    """(builder, fully-resolved plan) for this plan, device and bucketed
    length; the resolution is memoised."""
    backend = opts.resolve_backend()
    impl = _resolved_impl(opts, backend, device)
    sched = (opts.schedule if isinstance(opts.schedule, str)
             else id(opts.schedule))
    key = (backend, opts.v0, sched, opts.base_threshold, impl, str(device),
           pad_bucket(n))
    entry = _BUILDER_CACHE.get(key)
    if entry is None:
        _CACHE_STATS["misses"] += 1
        entry = (get_backend(backend), impl)
        _BUILDER_CACHE[key] = entry
    else:
        _CACHE_STATS["hits"] += 1
    builder, impl = entry
    if impl != opts.sort_impl:
        opts = opts.replace(sort_impl=impl)
    return builder, opts


def build_suffix_array(x, options: SAOptions | None = None, *,
                       device="cuda", **overrides) -> torch.Tensor:
    """Suffix array of `x` under the plan `options`: int32[n] on `device`.

    `x` is a 1-D sequence of non-negative integers below 2³¹ (tokens /
    bytes): array-like or a tensor. The build runs on `device`, ``"cuda"``
    unless the caller asks for ``"cpu"``; with no CUDA device and no
    ``device="cpu"`` it raises `RuntimeError`. Keyword overrides are
    applied on top of `options`, e.g. ``build_suffix_array(x,
    backend="seq", device="cpu")``.
    """
    with span("repro_torch.build"):
        return _build_suffix_array(x, options, device, overrides)


def _build_suffix_array(x, options, device, overrides) -> torch.Tensor:
    opts = options if options is not None else SAOptions()
    if overrides:
        opts = opts.replace(**overrides)
    if opts.sample_rate > 1:
        raise ValueError(
            f"build_suffix_array builds the DENSE full-length suffix array "
            f"(every registry backend's contract); sample_rate="
            f"{opts.sample_rate} plans go through the facade — "
            f"SuffixArrayIndex.build / .from_docs dispatch to "
            f"repro_torch.sparse.SparseSuffixArrayIndex, or call "
            f"repro_torch.sparse.build_sparse_suffix_array directly")
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
            raise TypeError(f"text must be integer-valued, got dtype "
                            f"{x.dtype}")
    else:
        x = np.asarray(x)
        if x.dtype.kind not in "iub":
            raise TypeError(f"text must be integer-valued, got dtype "
                            f"{x.dtype}")
        x = torch.from_numpy(x.astype(np.int64, copy=False))
    if x.dim() != 1:
        raise ValueError(f"text must be 1-D, got shape {tuple(x.shape)}")
    x = x.to(device=dev, dtype=torch.int64)
    n = len(x)
    if n and opts.validate:
        lo, hi = torch.stack(torch.aminmax(x)).tolist()
        if lo < 0:
            raise ValueError("text values must be ≥ 0 (negative values are "
                             "reserved for pad/separator sentinels)")
        if hi >= 2 ** 31:
            raise ValueError("text values must be < 2³¹")
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)

    if opts.cache:
        builder, opts = _cached_builder(opts, dev, n)
    else:
        builder = get_backend(opts.resolve_backend())
    sa = torch.as_tensor(builder(x, opts)).to(device=dev, dtype=torch.int32)
    if opts.validate and sa.shape != (n,):
        raise RuntimeError(
            f"backend {opts.resolve_backend()!r} returned shape "
            f"{tuple(sa.shape)}, expected ({n},)")
    return sa
