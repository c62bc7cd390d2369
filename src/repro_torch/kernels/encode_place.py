"""Launcher of the hand-written corpus layout kernel (`csrc/encode_place.cu`).

`encode_place_cuda` makes the sentinel-separator text of a multi-document
corpus from its documents' tokens back to back and their cumulative ends,
in one launch on the current stream, and raises a device flag where a token
is negative. `repro_torch.kernels.ops` dispatches to it for CUDA tensors
and to `ref.encode_place_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library
from .radix_hist import check_vector


def encode_place_cuda(flat: torch.Tensor,
                      ends: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(text int64[N + D], negative int32[1]) of int64[N] `flat` and
    int64[D] `ends`, both on one CUDA device; see `ref.encode_place_ref`
    for the contract."""
    n = check_vector(flat, torch.int64, "encode_place", "flat")
    d = check_vector(ends, torch.int64, "encode_place", "ends")
    if ends.device != flat.device:
        raise ValueError(f"encode_place: ends lies on {ends.device}, flat on "
                         f"{flat.device}")
    text = torch.empty(n + d, dtype=torch.int64, device=flat.device)
    negative = torch.empty(1, dtype=torch.int32, device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    check(library().repro_encode_place(
        flat.data_ptr(), ends.data_ptr(), n, d, text.data_ptr(),
        negative.data_ptr(), flat.device.index, stream), "encode_place")
    if n + d:
        LAUNCHES["encode_place"] += 1
    return text, negative
