"""`build_suffix_array` — the one entry point for suffix-array construction.

Validation, dtype normalisation and trivial-input fast paths live here so
every backend sees the same contract (an int64 1-D tensor on the build's
device, values in [0, 2³¹), n ≥ 2) and every caller gets the same result
type: an int32[n] tensor on that device, a permutation of range(n).
Each build handed to a backend (n ≥ 2) adds one to the
`repro_torch.trace` counter ``repro_torch.builds``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compat import resolve_device
from ..trace import count, span
from .options import SAOptions
from .registry import get_backend


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

    count("repro_torch.builds")
    builder = get_backend(opts.resolve_backend())
    sa = torch.as_tensor(builder(x, opts)).to(device=dev, dtype=torch.int32)
    if opts.validate and sa.shape != (n,):
        raise RuntimeError(
            f"backend {opts.resolve_backend()!r} returned shape "
            f"{tuple(sa.shape)}, expected ({n},)")
    return sa
