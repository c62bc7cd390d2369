"""Launcher of the hand-written CUDA scatter pass (`csrc/radix_scatter.cu`).

`radix_scatter_cuda` moves int64 keys and their payload to the slots one
stable 8-bit counting pass assigns them, given the per-(bin, block) start
offsets; `repro_torch.kernels.ops` dispatches to it for CUDA tensors and to
`ref.radix_scatter_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from ._build import LAUNCHES, check, library
from .radix_hist import check_vector

#: digits of one pass: 8 bits.
RADIX_BINS = 256
#: most elements a CUDA block takes: 256 threads of at most 16 elements.
MAX_BLOCK = 4096


def radix_scatter_cuda(keys: torch.Tensor, payload: torch.Tensor, shift: int,
                       offsets: torch.Tensor, block: int, *,
                       write_keys: bool = True):
    """One stable scatter pass on the current stream.

    keys int64[N] (non-negative), payload int32[N] or int64[N], offsets
    int32[256, ceil(N / block)], `block` a multiple of 256 in [256, 4096],
    `shift` in [0, 56]. Returns (keys_out or None, payload_out): element i
    lands at ``offsets[d, i // block]`` plus its rank among the elements
    before it in its block with the same digit d = (key >> shift) & 255."""
    n = check_vector(keys, torch.int64, "radix_scatter", "keys")
    if payload.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"radix_scatter: payload must be int32 or int64, got "
                        f"{payload.dtype}")
    if (check_vector(payload, payload.dtype, "radix_scatter", "payload") != n
            or payload.device != keys.device):
        raise ValueError(f"radix_scatter: payload {list(payload.shape)} on "
                         f"{payload.device} does not match keys [{n}] on "
                         f"{keys.device}")
    if block % 256 or not 256 <= block <= MAX_BLOCK:
        raise ValueError(f"radix_scatter: block={block} must be a multiple "
                         f"of 256 in [256, {MAX_BLOCK}]")
    if not 0 <= shift <= 56:
        raise ValueError(f"radix_scatter: shift={shift} outside [0, 56]")
    n_blocks = -(-n // block)
    if (offsets.device != keys.device or offsets.dtype != torch.int32
            or offsets.shape != (RADIX_BINS, n_blocks)
            or not offsets.is_contiguous()):
        raise ValueError(f"radix_scatter: offsets must be contiguous int32"
                         f"[{RADIX_BINS}, {n_blocks}] on {keys.device}, got "
                         f"{offsets.dtype}{list(offsets.shape)} on "
                         f"{offsets.device}")
    if n >= 2 ** 31:
        raise ValueError(f"radix_scatter: N={n} needs int32 offsets < 2³¹")
    keys_out = torch.empty_like(keys) if write_keys else None
    payload_out = torch.empty_like(payload)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    check(library().repro_radix_scatter(
        keys.data_ptr(), payload.data_ptr(),
        keys_out.data_ptr() if write_keys else None, payload_out.data_ptr(),
        offsets.data_ptr(), n, block, shift, payload.element_size(),
        keys.device.index, stream), "radix_scatter")
    LAUNCHES["radix_scatter"] += 1
    return keys_out, payload_out
