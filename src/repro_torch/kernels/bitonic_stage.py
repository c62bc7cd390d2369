"""Launcher of the hand-written CUDA bitonic stage (`csrc/bitonic_stage.cu`).

`bitonic_stage_cuda` applies one (k, j) compare-exchange stage in place to
int32[N, W] rows on a CUDA device; `repro_torch.kernels.ops` dispatches to
it for CUDA tensors and to `ref.bitonic_stage_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library


def check_rows(rows: torch.Tensor, kernel: str) -> tuple[int, int]:
    """Validate what a kernel takes: a contiguous int32[N, W] CUDA tensor.
    Returns (N, W)."""
    if rows.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got "
                         f"{rows.device}")
    if rows.dtype != torch.int32:
        raise TypeError(f"{kernel}: expected int32 rows, got {rows.dtype}")
    if rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"{kernel}: expected contiguous [N, W] rows, got "
                         f"shape {tuple(rows.shape)}")
    return rows.shape


def bitonic_stage_cuda(rows: torch.Tensor, k: int, j: int,
                       num_keys: int) -> torch.Tensor:
    """Apply stage (k, j) to `rows` in place on the current stream.
    N must be a power of two, j < k <= N powers of two,
    1 <= num_keys <= W. Returns `rows`."""
    n, w = check_rows(rows, "bitonic_stage")
    if n & (n - 1) or k & (k - 1) or j & (j - 1) or not 1 <= j < k <= n:
        raise ValueError(f"bitonic_stage: bad stage (k={k}, j={j}) "
                         f"for N={n}")
    if not 1 <= num_keys <= w:
        raise ValueError(f"bitonic_stage: num_keys={num_keys} outside "
                         f"[1, {w}]")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    check(library().repro_bitonic_stage(
        rows.data_ptr(), n, w, num_keys, k, j, rows.device.index, stream),
        "bitonic_stage")
    LAUNCHES["bitonic_stage"] += 1
    return rows
