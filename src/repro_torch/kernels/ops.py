"""Public wrappers of the kernels: sort and rank primitives of the build.

* `bitonic_stage` / `bitonic_sort` — one compare-exchange stage / a full
  row sort of int32[N, W] rows (`repro_torch.core.dcv_torch` sorts its
  window rows with `bitonic_sort` when ``sort_impl="kernel"``);
* `seg_boundary` — block-local boundaries and prefix sums of sorted rows;
* `dense_rank_sorted` — dense ranks of sorted rows: `seg_boundary` plus
  a block stitch in PyTorch ops (the Step-1 sample ranking).

Each wrapper picks its path from the tensor it is given: a CUDA tensor
runs the hand-written kernel (`bitonic_stage.cu`, `seg_boundary.cu`), a CPU
tensor runs the plain version in `ref`. Any other device raises.
`LAUNCHES` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .bitonic_stage import bitonic_stage_cuda
from .seg_boundary import seg_boundary_cuda

__all__ = ["LAUNCHES", "bitonic_sort", "bitonic_stage", "dense_rank_sorted",
           "seg_boundary"]


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{op}: unsupported device {t.device}")


def bitonic_stage(rows: torch.Tensor, k: int, j: int,
                  num_keys: int | None = None, *,
                  inplace: bool = False) -> torch.Tensor:
    """One bitonic compare-exchange stage (k, j) over rows int32[N, W].

    N must be a power of two; rows compare lexicographically on their first
    `num_keys` columns (default: all). Row i exchanges with row i^j,
    ascending iff (i & k) == 0. With ``inplace=True`` the result is written
    into `rows`, which is returned."""
    num_keys = num_keys or rows.shape[1]
    if _on_cuda(rows, "bitonic_stage"):
        return bitonic_stage_cuda(rows if inplace else rows.clone(), k, j,
                                  num_keys)
    out = ref.bitonic_stage_ref(rows, k, j, num_keys)
    return rows.copy_(out) if inplace else out


def bitonic_sort(rows: torch.Tensor,
                 num_keys: int | None = None) -> torch.Tensor:
    """Full bitonic row sort: every (k, j) stage of `bitonic_stage` in
    turn, log2(N)·(log2(N)+1)/2 of them, on a copy of `rows` (int32[N, W],
    N a power of two). Sorts ascending by the first `num_keys` columns;
    append a unique index column to make the order total."""
    n = rows.shape[0]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort needs a power-of-two row count, "
                         f"got {n}")
    out = rows.clone()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            out = bitonic_stage(out, k, j, num_keys, inplace=True)
            j //= 2
        k *= 2
    return out


def seg_boundary(rows: torch.Tensor, num_keys: int | None = None,
                 block: int = 512):
    """Sorted rows int32[N, W] (N a multiple of `block`) -> (flags int32[N],
    csum int32[N], totals int32[N // block]); see `ref.seg_boundary_ref`."""
    num_keys = num_keys or rows.shape[1]
    if _on_cuda(rows, "seg_boundary"):
        return seg_boundary_cuda(rows, num_keys, block)
    return ref.seg_boundary_ref(rows, num_keys, block)


def dense_rank_sorted(rows: torch.Tensor, num_keys: int | None = None,
                      block: int = 512):
    """Dense ranks of lexicographically sorted rows [N, W], N >= 1.

    `seg_boundary` computes block-local boundaries and prefix sums; this
    wrapper stitches the blocks. Rows must already be sorted by their first
    `num_keys` columns (default: all). Equal rows share a rank; ranks are
    dense (0 .. num_distinct - 1).

    Returns (ranks int32[N], num_distinct int32 0-d tensor)."""
    n, w = rows.shape
    num_keys = num_keys or w
    pad = (-n) % block
    rows_p = (torch.cat([rows, rows[-1:].expand(pad, w)], dim=0) if pad
              else rows.contiguous())
    flags, csum, totals = seg_boundary(rows_p, num_keys, block)
    nb = rows_p.shape[0] // block
    base = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    if nb > 1:
        # block b's flag[0] is forced to 1; where the rows on either side of
        # the block edge are equal, every rank inside block b over-counts by
        # one from that false boundary.
        edge_prev = rows_p[block - 1:-1:block, :num_keys]
        edge_next = rows_p[block::block, :num_keys]
        same = (edge_prev == edge_next).all(dim=1)
        corr = torch.zeros(nb, dtype=torch.int32, device=rows.device)
        corr[1:] = torch.cumsum(same, 0, dtype=torch.int32)
        base = base - corr
    ranks = (base[:, None] + csum.view(nb, block) - 1).reshape(-1)[:n]
    return ranks, ranks[-1] + 1
