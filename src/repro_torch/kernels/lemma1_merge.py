"""Launcher of the hand-written Lemma-1 tie merge (`csrc/lemma1_merge.cu`).

`lemma1_merge_cuda` places the tied rows of a DC-v level, sorted by (tie
group, class, key), in Lemma-1 comparator order, one thread a row, in one
launch on the current stream. `repro_torch.kernels.ops` dispatches to it
for CUDA tensors and to `ref.lemma1_merge_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library
from .radix_hist import check_vector


def lemma1_merge_cuda(p: torch.Tensor, klass: torch.Tensor,
                      rvals: torch.Tensor, lane: torch.Tensor,
                      width: torch.Tensor, lam1: torch.Tensor,
                      lam2: torch.Tensor) -> torch.Tensor:
    """int64[U]: the positions `p` in their slots; see
    `ref.lemma1_merge_ref` for the contract. p, klass, lane and width are
    int64[U], rvals int64[U, |D|], lam1 and lam2 int64[v, v], all on one
    CUDA device."""
    n = check_vector(p, torch.int64, "lemma1_merge", "p")
    for name, t in (("klass", klass), ("lane", lane), ("width", width)):
        if check_vector(t, torch.int64, "lemma1_merge", name) != n:
            raise ValueError(f"lemma1_merge: {name} has {t.shape[0]} rows, "
                             f"p {n}")
    v = lam1.shape[0]
    for name, t in (("lam1", lam1), ("lam2", lam2)):
        if (t.dtype != torch.int64 or t.shape != (v, v)
                or not t.is_contiguous()):
            raise ValueError(f"lemma1_merge: {name} must be contiguous "
                             f"int64[v, v], got {t.dtype}{list(t.shape)}")
    if (rvals.dtype != torch.int64 or rvals.dim() != 2
            or rvals.shape[0] != n or not rvals.is_contiguous()):
        raise ValueError(f"lemma1_merge: rvals must be contiguous int64[{n}, "
                         f"|D|], got {rvals.dtype}{list(rvals.shape)}")
    if any(t.device != p.device for t in (klass, rvals, lane, width, lam1,
                                          lam2)):
        raise ValueError("lemma1_merge: every tensor must lie on "
                         f"{p.device}")
    out = p.clone()                   # slots a failed exchange leaves
    if n:
        stream = torch.cuda.current_stream(p.device).cuda_stream
        check(library().repro_lemma1_merge(
            p.data_ptr(), klass.data_ptr(), rvals.data_ptr(),
            lane.data_ptr(), width.data_ptr(), lam1.data_ptr(),
            lam2.data_ptr(), n, v, rvals.shape[1], out.data_ptr(),
            p.device.index, stream), "lemma1_merge")
        LAUNCHES["lemma1_merge"] += 1
    return out
