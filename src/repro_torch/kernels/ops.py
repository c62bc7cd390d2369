"""Public wrappers of the kernels: sort and rank primitives of the build.

* `bitonic_stage` — one compare-exchange stage of int32[N, W] rows
  (`bitonic_stage.cu`);
* `bitonic_launch` / `bitonic_sort` — one launch of
  `bitonic_sort.schedule` (a run of stages in shared memory,
  `bitonic_sort.cu`) / a full row sort in those launches
  (`repro_torch.core.dcv_torch` sorts its window rows with it when
  ``sort_impl="kernel"``);
* `seg_boundary` — block-local boundaries and prefix sums of sorted rows
  (the TPU kernel's contract; off every build path);
* `dense_rank_sorted` — dense ranks of sorted rows in one pass
  (`dense_rank.cu`, its rows form; the "kernel" build's Step-1 sample
  ranks);
* `dense_rank_gathered` — the same of rows gathered from packed words
  through an order (`dense_rank.cu`, its gathered form; the run starts and
  sample ranks of the "radix" build, the sparse build's head ranks);
* `radix_histogram_blocks` / `radix_histogram` — per-block / global digit
  histograms (`radix_hist.cu`, its digit loader);
* `radix_pass_counts` — one radix pass's digit counts taken straight from
  the int64 keys, bin-major (`radix_hist.cu`, its key loader);
* `radix_scatter` — one stable 8-bit scatter pass (`radix_scatter.cu`);
* `radix_argsort` — the stable LSD radix argsort of packed int64 words on
  those two (``sort_impl="radix"`` window sorts, the sparse build, the
  Lemma-1 class sort);
* `lemma1_merge` — the tied rows of a level, class-sorted, placed in
  Lemma-1 comparator order in one pass (`lemma1_merge.cu`; every keyed
  build's tie resolution, `core.words.lemma1_order`);
* `encode_place` — the sentinel-separator text of a corpus made on the
  device from its documents' tokens back to back (`encode_place.cu`;
  `SuffixArrayIndex.from_docs` and every caller of `api.index.stage_docs`).

Each wrapper picks its path from the tensor it is given: a CUDA tensor
runs the hand-written kernel (`bitonic_stage.cu`, `bitonic_sort.cu`,
`seg_boundary.cu`, `dense_rank.cu`, `radix_hist.cu`, `radix_scatter.cu`,
`lemma1_merge.cu`, `encode_place.cu`), a CPU tensor runs the plain version
in `ref`. Any other device raises.
`LAUNCHES` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .bitonic_sort import bitonic_launch_cuda, schedule
from .bitonic_stage import bitonic_stage_cuda
from .dense_rank import dense_rank_gather_cuda, dense_rank_rows_cuda
from .encode_place import encode_place_cuda
from .lemma1_merge import lemma1_merge_cuda
from .radix_hist import radix_histogram_cuda, radix_pass_counts_cuda
from .radix_scatter import radix_scatter_cuda
from .seg_boundary import seg_boundary_cuda

__all__ = ["LAUNCHES", "bitonic_launch", "bitonic_sort", "bitonic_stage",
           "dense_rank_gathered", "dense_rank_sorted", "encode_place",
           "lemma1_merge", "radix_argsort", "radix_histogram",
           "radix_histogram_blocks", "radix_pass_counts", "radix_scatter",
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


def bitonic_launch(rows: torch.Tensor, launch, num_keys: int | None = None,
                   *, inplace: bool = False) -> torch.Tensor:
    """One launch of `bitonic_sort.schedule` over rows int32[N, W]: its run
    of stages (k, j), each exactly `bitonic_stage`. With ``inplace=True``
    the result is written into `rows`, which is returned."""
    num_keys = num_keys or rows.shape[1]
    if _on_cuda(rows, "bitonic_launch"):
        return bitonic_launch_cuda(rows if inplace else rows.clone(), launch,
                                   num_keys)
    out = ref.bitonic_stages_ref(rows, launch.stages(), num_keys)
    return rows.copy_(out) if inplace else out


def bitonic_sort(rows: torch.Tensor,
                 num_keys: int | None = None) -> torch.Tensor:
    """Full bitonic row sort of a copy of `rows` (int32[N, W], N a power of
    two): every (k, j) stage in turn, log2(N)·(log2(N)+1)/2 of them, grouped
    into the launches of `bitonic_sort.schedule` (30 at N = 2^24, W = 4).
    Sorts ascending by the first `num_keys` columns; append a unique index
    column to make the order total. The result equals `bitonic_stage`
    applied stage by stage, bit for bit."""
    n, w = rows.shape
    if n & (n - 1):
        raise ValueError(f"bitonic_sort needs a power-of-two row count, "
                         f"got {n}")
    _on_cuda(rows, "bitonic_sort")
    out = rows.clone()
    for launch in schedule(n, w):
        out = bitonic_launch(out, launch, num_keys, inplace=True)
    return out


def seg_boundary(rows: torch.Tensor, num_keys: int | None = None,
                 block: int = 512):
    """Sorted rows int32[N, W] (N a multiple of `block`) -> (flags int32[N],
    csum int32[N], totals int32[N // block]); see `ref.seg_boundary_ref`."""
    num_keys = num_keys or rows.shape[1]
    if _on_cuda(rows, "seg_boundary"):
        return seg_boundary_cuda(rows, num_keys, block)
    return ref.seg_boundary_ref(rows, num_keys, block)


def dense_rank_sorted(rows: torch.Tensor, num_keys: int | None = None):
    """Dense ranks of lexicographically sorted rows [N, W], N >= 1.

    Rows must already be sorted by their first `num_keys` columns (default:
    all). Equal rows share a rank; ranks are dense (0 .. num_distinct - 1).
    On a CUDA tensor one launch of `dense_rank.cu` computes them, carrying
    the count across tiles itself.

    Returns (ranks int32[N], num_distinct int32 0-d tensor)."""
    num_keys = num_keys or rows.shape[1]
    if _on_cuda(rows, "dense_rank_sorted"):
        return dense_rank_rows_cuda(rows.contiguous(), num_keys)
    return ref.dense_rank_rows_ref(rows, num_keys)


def dense_rank_gathered(words, pos: torch.Tensor):
    """Dense ranks of the rows (words[0][pos[i]], ..., words[K-1][pos[i]])
    of int64 `words`, which `pos` (int64[N]) sorts: (ranks int32[N],
    is_start bool[N], n_distinct int32 0-d); see
    `ref.dense_rank_gathered_ref`. On a CUDA tensor one launch of
    `dense_rank.cu` gathers each word once a row."""
    if _on_cuda(pos, "dense_rank_gathered"):
        return dense_rank_gather_cuda(words, pos)
    return ref.dense_rank_gathered_ref(words, pos)


def radix_histogram_blocks(digits: torch.Tensor, n_bins: int,
                           block: int = 1024) -> torch.Tensor:
    """Per-block histograms of int32[N] digits in [0, n_bins):
    int32[ceil(N / block), n_bins].

    N is padded up to a multiple of `block` with the digit `n_bins`, which
    the kernel counts in a scratch bin that is dropped (the pad rule of
    `repro.kernels.ops.radix_histogram`)."""
    pad = (-digits.shape[0]) % block
    if pad:
        digits = torch.cat([digits, digits.new_full((pad,), n_bins)])
    bins = n_bins + (1 if pad else 0)
    if _on_cuda(digits, "radix_hist"):
        out = radix_histogram_cuda(digits, bins, block)
    else:
        out = ref.radix_histogram_ref(digits, bins, block)
    return out[:, :n_bins] if pad else out


def radix_histogram(digits: torch.Tensor, n_bins: int,
                    block: int = 1024) -> torch.Tensor:
    """Global histogram of int32[N] digits in [0, n_bins): int32[n_bins],
    the sum of `radix_histogram_blocks` over blocks."""
    return radix_histogram_blocks(digits, n_bins, block).sum(
        0, dtype=torch.int32)


def radix_pass_counts(keys: torch.Tensor, shift: int,
                      block: int = ref.SORT_BLOCK) -> torch.Tensor:
    """Digit counts of one LSD pass over int64[N] non-negative `keys`:
    int32[256 * ceil(N / block) + 1], a 0 and then, bin-major, the count
    of each digit (key >> shift) & 255 in each block; see
    `ref.radix_pass_counts_ref`."""
    if _on_cuda(keys, "radix_hist"):
        return radix_pass_counts_cuda(keys, shift, block)
    return ref.radix_pass_counts_ref(keys, shift, block)


def radix_scatter(keys: torch.Tensor, payload: torch.Tensor, shift: int,
                  offsets: torch.Tensor, block: int = ref.SORT_BLOCK, *,
                  write_keys: bool = True):
    """One stable 8-bit scatter pass; see `ref.radix_scatter_ref`.
    Returns (keys_out or None, payload_out)."""
    if _on_cuda(keys, "radix_scatter"):
        return radix_scatter_cuda(keys, payload, shift, offsets, block,
                                  write_keys=write_keys)
    return ref.radix_scatter_ref(keys, payload, shift, offsets, block,
                                 write_keys=write_keys)


def radix_argsort(words, key_bits,
                  block: int = ref.SORT_BLOCK) -> torch.Tensor:
    """Stable LSD radix argsort of a list of int64 words, most significant
    first (each non-negative and below 2**key_bits; `key_bits` one int or
    one per word): int64[N] positions sorted by (words..., position).

    ceil(key_bits / 8) passes a word, each one `radix_pass_counts`, one
    `torch.cumsum` of its counts into offsets and one `radix_scatter`
    (`ref.lsd_argsort`). On a CUDA tensor every pass runs the two kernels;
    nothing falls back to a library sort."""
    _on_cuda(words[0], "radix_argsort")
    return ref.lsd_argsort(words, key_bits, radix_pass_counts,
                           radix_scatter, block)


def lemma1_merge(p: torch.Tensor, klass: torch.Tensor, rvals: torch.Tensor,
                 lane: torch.Tensor, width: torch.Tensor, lam1: torch.Tensor,
                 lam2: torch.Tensor) -> torch.Tensor:
    """The tied rows of a level, sorted by (group, class, key), placed in
    Lemma-1 comparator order: int64[U], the positions `p` in their slots;
    see `ref.lemma1_merge_ref`. On a CUDA tensor one launch of
    `lemma1_merge.cu`."""
    if _on_cuda(p, "lemma1_merge"):
        return lemma1_merge_cuda(p, klass, rvals, lane, width, lam1, lam2)
    return ref.lemma1_merge_ref(p, klass, rvals, lane, width, lam1, lam2)


def encode_place(flat: torch.Tensor,
                 ends: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sentinel-separator text of a corpus whose documents' tokens lie
    back to back in `flat`, with cumulative ends `ends`, and a flag raised
    by a negative token: ``(text int64[N + D], negative int32[1])``; see
    `ref.encode_place_ref`. On a CUDA tensor one launch of
    `encode_place.cu`."""
    if _on_cuda(flat, "encode_place"):
        return encode_place_cuda(flat, ends)
    return ref.encode_place_ref(flat, ends)
