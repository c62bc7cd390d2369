"""Launcher of the hand-written CUDA segment-boundary kernel
(`csrc/seg_boundary.cu`).

`seg_boundary_cuda` computes, for each block of `block` sorted int32[N, W]
rows on a CUDA device, the boundary flags (first row of a block forced to
a boundary), their block-inclusive cumsum and the block totals;
`repro_torch.kernels.ops` dispatches to it for CUDA tensors and to
`ref.seg_boundary_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library
from .bitonic_stage import check_rows


def seg_boundary_cuda(rows: torch.Tensor, num_keys: int, block: int):
    """(flags int32[N], csum int32[N], totals int32[N // block]) of sorted
    `rows`. N must be a multiple of `block`, a power of two in [32, 1024]."""
    n, w = check_rows(rows, "seg_boundary")
    if block & (block - 1) or not 32 <= block <= 1024:
        raise ValueError(f"seg_boundary: block={block} must be a power of "
                         f"two in [32, 1024]")
    if n % block:
        raise ValueError(f"seg_boundary: N={n} is not a multiple of "
                         f"block={block}")
    if not 1 <= num_keys <= w:
        raise ValueError(f"seg_boundary: num_keys={num_keys} outside "
                         f"[1, {w}]")
    flags = torch.empty(n, dtype=torch.int32, device=rows.device)
    csum = torch.empty_like(flags)
    totals = torch.empty(n // block, dtype=torch.int32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    check(library().repro_seg_boundary(
        rows.data_ptr(), flags.data_ptr(), csum.data_ptr(),
        totals.data_ptr(), n, w, num_keys, block, rows.device.index, stream),
        "seg_boundary")
    LAUNCHES["seg_boundary"] += 1
    return flags, csum, totals
