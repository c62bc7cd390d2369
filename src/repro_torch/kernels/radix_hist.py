"""Launchers of the hand-written CUDA counting kernel (`csrc/radix_hist.cu`).

`radix_pass_counts_cuda` counts one LSD pass straight from the int64 sort
keys: the digit (key >> shift) & 255 of every element, per block, written
bin-major and led by a 0, so that one `torch.cumsum` gives the scatter's
offsets. `radix_histogram_cuda` keeps the TPU kernel's contract: per-block
histograms of int32 digits. `repro_torch.kernels.ops` dispatches to them for
CUDA tensors and to `ref.radix_pass_counts_ref` / `ref.radix_histogram_ref`
for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library

#: most bins a launch takes: the block's histogram lives in the 48 KB of
#: shared memory a CUDA block gets without opting in (4 bytes a bin).
MAX_BINS = 48 * 1024 // 4
#: digits of one pass of the radix sort: 8 bits.
PASS_BINS = 256


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


def radix_pass_counts_cuda(keys: torch.Tensor, shift: int,
                           block: int) -> torch.Tensor:
    """int32[256 * nb + 1], nb = ceil(N / block), for int64[N] `keys`
    (non-negative), on the current stream: element 0 is 0 and element
    1 + d * nb + b counts the keys of block b whose digit
    (key >> shift) & 255 is d. See `ref.radix_pass_counts_ref`."""
    n = check_vector(keys, torch.int64, "radix_hist", "keys")
    if block < 1:
        raise ValueError(f"radix_hist: block={block} must be positive")
    if not 0 <= shift <= 56:
        raise ValueError(f"radix_hist: shift={shift} outside [0, 56]")
    if n >= 2 ** 31:
        raise ValueError(f"radix_hist: N={n} needs int32 counts < 2³¹")
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=keys.device)
    out = torch.empty(PASS_BINS * -(-n // block) + 1, dtype=torch.int32,
                      device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    check(library().repro_radix_pass_counts(
        keys.data_ptr(), out.data_ptr(), n, block, shift, keys.device.index,
        stream), "radix_hist")
    LAUNCHES["radix_hist"] += 1
    return out


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
    if n == 0:
        return out
    stream = torch.cuda.current_stream(digits.device).cuda_stream
    check(library().repro_radix_hist(
        digits.data_ptr(), out.data_ptr(), n, block, n_bins,
        digits.device.index, stream), "radix_hist")
    LAUNCHES["radix_hist"] += 1
    return out
