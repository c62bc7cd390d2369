"""Device resolution and the `sort_impl` names of the port.

Entry points take ``device=`` and default to ``"cuda"``. `resolve_device`
raises when CUDA is asked for and absent: the port never carries on on
the CPU unless the caller asks for it with ``device="cpu"``.

`sort_impl` selects the window-sort primitive of `dcv_torch`:

==========  ==============================================================
"kernel"    the hand-written Hopper kernels in `repro_torch.kernels` (row
            bitonic sort + `dense_rank_sorted`); on a CPU tensor the same
            code path runs their plain PyTorch versions. The counterpart
            of the JAX package's "pallas".
"torch"     stock `torch.sort(stable=True)` over packed int64 window keys,
            the counterpart of "lax"; the yardstick for "kernel".
"radix"     packed int64 window words sorted by `radix_argsort` (the
            counterpart of the JAX "radix"): an LSD radix sort on the
            hand-written histogram and scatter kernels, their plain
            versions on a CPU tensor.
"bitonic"   the legacy fused path: a key sort of the sample windows and
            one comparator-bitonic network (`core.bitonic`, plain PyTorch
            ops) over every suffix of a level, as the JAX package's
            "bitonic".
"auto"      resolves by device (`default_sort_impl`): "radix" on a CUDA
            device, "kernel" on the CPU.
==========  ==============================================================

The bsp backend takes "auto", "radix", "torch" and "bitonic" and rejects
"kernel" (`repro_torch.bsp.psort.resolve_bsp_sort_impl`).
"""
from __future__ import annotations

import torch

#: accepted `sort_impl` values ("auto" resolves via `default_sort_impl`).
SORT_IMPLS = ("auto", "torch", "kernel", "radix", "bitonic")


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises `RuntimeError` for a CUDA
    device on a host without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def check_sort_impl(sort_impl: str) -> str:
    """Validate a `sort_impl` name; returns it unchanged."""
    if sort_impl not in SORT_IMPLS:
        raise ValueError(f"unknown sort_impl {sort_impl!r}; "
                         f"expected one of {SORT_IMPLS}")
    return sort_impl


def default_sort_impl(device) -> str:
    """What "auto" resolves to on `device`: "radix" on a CUDA device (the
    LSD radix sort on the hand-written histogram and scatter kernels, the
    fastest window sort of the three there), "kernel" on the CPU."""
    return "radix" if torch.device(device).type == "cuda" else "kernel"


def resolve_sort_impl(sort_impl: str, device) -> str:
    """Validate `sort_impl` and resolve "auto" for `device`."""
    check_sort_impl(sort_impl)
    return default_sort_impl(device) if sort_impl == "auto" else sort_impl
