"""Launcher of the hand-written CUDA histogram kernel (`csrc/radix_hist.cu`).

`radix_histogram_cuda` counts, for each block of `block` int32 digits on a
CUDA device, how many equal each of `n_bins` bins; `repro_torch.kernels.ops`
dispatches to it for CUDA tensors and to `ref.radix_histogram_ref` for CPU
tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library

#: most bins a launch takes: the block's histogram lives in the 48 KB of
#: shared memory a CUDA block gets without opting in (4 bytes a bin).
MAX_BINS = 48 * 1024 // 4


def check_vector(t: torch.Tensor, dtype: torch.dtype, kernel: str,
                 what: str) -> int:
    """Validate a contiguous 1-D CUDA tensor of `dtype`; returns its length."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: expected {dtype} {what}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{kernel}: expected contiguous 1-D {what}, got "
                         f"shape {tuple(t.shape)}")
    return t.shape[0]


def radix_histogram_cuda(digits: torch.Tensor, n_bins: int,
                         block: int) -> torch.Tensor:
    """int32[N // block, n_bins] per-block histograms of int32[N] `digits`
    (N a multiple of `block`; digits outside [0, n_bins) count nowhere),
    on the current stream."""
    n = check_vector(digits, torch.int32, "radix_hist", "digits")
    if block < 1 or n % block:
        raise ValueError(f"radix_hist: N={n} is not a multiple of "
                         f"block={block}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"radix_hist: n_bins={n_bins} outside [1, "
                         f"{MAX_BINS}] (the histogram lives in 48 KB of "
                         f"shared memory)")
    out = torch.empty((n // block, n_bins), dtype=torch.int32,
                      device=digits.device)
    stream = torch.cuda.current_stream(digits.device).cuda_stream
    check(library().repro_radix_hist(
        digits.data_ptr(), out.data_ptr(), n, block, n_bins,
        digits.device.index, stream), "radix_hist")
    LAUNCHES["radix_hist"] += 1
    return out
