"""Launchers of the hand-written single-pass dense-rank kernel
(`csrc/dense_rank.cu`).

`dense_rank_rows_cuda` ranks sorted int32[N, W] rows (the Step-1 sample
ranks of the "kernel" build); `dense_rank_gather_cuda` ranks the rows
(words[0][pos[i]], ..., words[K-1][pos[i]]) of packed int64 words gathered
through an order (the window order's run starts and the sample ranks of the
default "radix" build, the sparse build's head ranks). Both launch once, on
the current stream, and do not synchronise. `repro_torch.kernels.ops`
dispatches to them for CUDA tensors and to `ref.dense_rank_rows_ref` /
`ref.dense_rank_gathered_ref` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import LAUNCHES, check, library
from .bitonic_stage import check_rows
from .radix_hist import check_vector

#: rows a CUDA block ranks (kTile in the source): the scratch holds one
#: status word a tile.
TILE_ROWS = 2048
#: most words of a gathered row (kMaxWords in the source): the largest K
#: that `core.seq_ref.accelerated_next_v` gives any level of an input below
#: 2^31 tokens whose values are below 2^31 (`tests/test_torch_dense_rank.py`
#: recomputes it). The pointers fill a kernel parameter of 9,312 bytes.
MAX_WORDS = 1164
#: ranks and counts are int32.
MAX_ROWS = 2 ** 31 - 1


def _outputs(n: int, device: torch.device):
    """(ranks int32[n], zeroed scratch, n_distinct): the scratch is one
    int64 tensor, the tile counter, n_distinct in the low half of word 1
    (the 0-d int32 view returned) and one status word a tile."""
    ranks = torch.empty(n, dtype=torch.int32, device=device)
    scratch = torch.zeros(-(-n // TILE_ROWS) + 2, dtype=torch.int64,
                          device=device)
    return ranks, scratch, scratch[1:2].view(torch.int32)[0]


def _check_n(n: int, kernel: str) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{kernel}: N={n} needs int32 ranks (at most "
                         f"{MAX_ROWS} rows)")


def dense_rank_rows_cuda(rows: torch.Tensor, num_keys: int):
    """(ranks int32[N], n_distinct int32 0-d) of int32[N, W] `rows` sorted
    by their first `num_keys` columns: ranks[i] counts the rows before i
    that start a run (differ from their predecessor there)."""
    n, w = check_rows(rows, "dense_rank_rows")
    if not 1 <= num_keys <= w:
        raise ValueError(f"dense_rank_rows: num_keys={num_keys} outside "
                         f"[1, {w}]")
    _check_n(n, "dense_rank_rows")
    ranks, scratch, n_distinct = _outputs(n, rows.device)
    if n:
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        check(library().repro_dense_rank_rows(
            rows.data_ptr(), n, w, num_keys, ranks.data_ptr(),
            scratch.data_ptr(), rows.device.index, stream),
            "dense_rank_rows")
        LAUNCHES["dense_rank_rows"] += 1
    return ranks, n_distinct


def dense_rank_gather_cuda(words, pos: torch.Tensor):
    """(ranks int32[N], is_start bool[N], n_distinct int32 0-d) of the rows
    (words[0][pos[i]], ..., words[K-1][pos[i]]), in the order of `pos`
    (int64[N], every entry a valid index of every word). is_start[i] says
    row i differs from row i-1 (is_start[0] is True) and ranks is
    cumsum(is_start) - 1."""
    k = len(words)
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"dense_rank_gather: {k} words; the kernel takes 1 "
                         f"to {MAX_WORDS} (the cap of its parameter struct)")
    n = check_vector(pos, torch.int64, "dense_rank_gather", "pos")
    for word in words:
        check_vector(word, torch.int64, "dense_rank_gather", "words")
        if word.device != pos.device:
            raise ValueError(f"dense_rank_gather: a word on {word.device}, "
                             f"pos on {pos.device}")
    _check_n(n, "dense_rank_gather")
    ranks, scratch, n_distinct = _outputs(n, pos.device)
    is_start = torch.empty(n, dtype=torch.bool, device=pos.device)
    if n:
        ptrs = (ctypes.c_void_p * k)(*(word.data_ptr() for word in words))
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        check(library().repro_dense_rank_gather(
            ptrs, k, pos.data_ptr(), n, ranks.data_ptr(), is_start.data_ptr(),
            scratch.data_ptr(), pos.device.index, stream),
            "dense_rank_gather")
        LAUNCHES["dense_rank_gather"] += 1
    return ranks, is_start, n_distinct
