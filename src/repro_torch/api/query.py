"""Batched query execution — many patterns, one vectorised search.

* `QueryBatch` encodes many patterns into ONE padded buffer
  (`int[B_pad, L_pad]` + per-row lengths), with both axes quantised onto a
  power-of-two grid.
* `stage_batch` starts the host→device copy of a batch from pinned memory
  (`non_blocking`), so it can ride under work already queued on the card.
* `batch_ranges` runs the **vectorised double binary search**
  (`_ranges_kernel`): all B patterns advance their (lower, upper) SA
  bounds in lock-step; every step is one `[B, 2, L]` gather of text
  windows and one masked prefix comparison. Results come back as numpy
  int64 arrays, the layout of the JAX package's query engine.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

#: pattern-length buckets never go below this (tiny patterns share shapes).
_MIN_LEN_BUCKET = 8


def pow2_bucket(m: int, floor: int = 1) -> int:
    """Smallest power of two ≥ max(m, floor)."""
    m = max(int(m), floor, 1)
    return 1 << (m - 1).bit_length()


class QueryBatch:
    """Many encoded patterns in one padded, bucketed buffer.

    Rows are patterns *after* `SuffixArrayIndex._encode_pattern` (shift
    applied, alphabet validated); `lens[i]` is the true length of row i and
    columns past it are padding (masked in the search). Both axes are
    padded up to power-of-two buckets (`L` has a floor of 8); padded rows
    have length 0 and are sliced off the results.

    A `QueryBatch` is **bound to the index that encoded it** (the
    shift/sigma are baked into the values): running it against any other
    index raises `ValueError`.
    """

    __slots__ = ("pats", "lens", "n_queries", "_index_ref")

    def __init__(self, pats: np.ndarray, lens: np.ndarray, n_queries: int,
                 index=None):
        self.pats = pats            # int[B_pad, L_pad], encoded + padded
        self.lens = lens            # int32[B_pad], 0 for padding rows
        self.n_queries = int(n_queries)
        self._index_ref = (weakref.ref(index) if index is not None
                           else lambda: None)

    def check_bound_to(self, index) -> None:
        """Raise unless this batch was encoded by `index`."""
        if self._index_ref() is not index:
            raise ValueError(
                "QueryBatch was encoded against a different index (or one "
                "that no longer exists) — re-encode with "
                "QueryBatch.encode(index, patterns)")

    @classmethod
    def encode(cls, index, patterns, dtype=np.int32) -> "QueryBatch":
        """Encode `patterns` (a sequence of int sequences) against `index`."""
        return cls.from_encoded(index, [index._encode_pattern(p)
                                        for p in patterns], dtype)

    @classmethod
    def from_encoded(cls, index, enc, dtype=np.int32) -> "QueryBatch":
        """Build a batch from patterns already passed through
        `index._encode_pattern`."""
        B = len(enc)
        max_len = max((len(p) for p in enc), default=0)
        pats = np.zeros((pow2_bucket(B),
                         pow2_bucket(max_len, floor=_MIN_LEN_BUCKET)), dtype)
        lens = np.zeros(pats.shape[0], np.int32)
        cap = np.iinfo(dtype).max
        for i, p in enumerate(enc):
            if len(p) and int(p.max()) >= cap:
                # every text symbol is < cap (enforced by _device_state), so
                # clamping keeps every text-vs-pattern comparison exact
                # instead of wrapping to a false match.
                p = np.minimum(p, cap)
            pats[i, :len(p)] = p
            lens[i] = len(p)
        return cls(pats, lens, B, index=index)

    @property
    def bucket(self) -> tuple[int, int]:
        """(B_pad, L_pad) — the padded shape this batch runs at."""
        return tuple(self.pats.shape)

    def __len__(self) -> int:
        return self.n_queries

    def __repr__(self) -> str:
        return (f"QueryBatch(n_queries={self.n_queries}, "
                f"bucket={self.bucket})")


def _ranges_kernel(text: torch.Tensor, sa: torch.Tensor, pats: torch.Tensor,
                   lens: torch.Tensor):
    """Vectorised double binary search: all patterns, both bounds, at once.

    text int32[n], sa int64[n], pats int32[B, L], lens int32[B], all on one
    device. For each pattern row two binary-search states run over SA
    ranks — bound 0 converges to the first suffix ≥ pattern, bound 1 to the
    first suffix > pattern (prefix match counts as equal), so `[lo, hi)`
    is the block of suffixes starting with the pattern. Every step probes
    both bounds of every pattern with one `[B, 2, L]` gather and one masked
    3-way prefix comparison (past-the-end reads as -1, below every real
    character). Rows of length 0 resolve to (0, n). The step count is
    ceil(log2(n + 1)) + 1, a Python loop of PyTorch ops.
    Returns (lo int64[B], hi int64[B]) on the device.
    """
    n = text.shape[0]
    B, L = pats.shape
    device = text.device
    steps = max(int(n).bit_length(), 1) + 1
    col = torch.arange(L, device=device)
    pat = pats[:, None, :].expand(B, 2, L)
    valid = col[None, None, :] < lens[:, None, None]
    lo = torch.zeros((B, 2), dtype=torch.int64, device=device)
    hi = torch.full((B, 2), n, dtype=torch.int64, device=device)
    for _ in range(steps):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        start = sa[torch.where(active, mid, 0)]                 # [B, 2]
        idx = start[..., None] + col                            # [B, 2, L]
        chars = torch.where(idx < n, text[idx.clamp(max=n - 1)], -1)
        diff = (chars != pat) & valid
        any_diff = diff.any(dim=-1)
        # torch.argmax takes no bool input; the first 1 is the first diff
        first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)
        s_at = chars.gather(-1, first)[..., 0]
        p_at = pat.gather(-1, first)[..., 0]
        less = any_diff & (s_at < p_at)          # suffix < pattern
        greater = any_diff & (s_at > p_at)       # suffix > pattern
        # bound 0 moves right while suffix < pat; bound 1 while suffix ≤ pat
        before = torch.stack([less[:, 0], ~greater[:, 1]], dim=1)
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo[:, 0], lo[:, 1]


def stage_batch(index, batch: QueryBatch):
    """Begin the host→device copy of a batch's buffers: pinned host memory,
    `non_blocking` copies on the current stream. Returns the staged
    (pats, lens) tensors for `batch_ranges(..., staged=)`."""
    batch.check_bound_to(index)
    dev = index.device
    pats = torch.from_numpy(batch.pats)
    lens = torch.from_numpy(batch.lens)
    if dev.type == "cuda":
        pats, lens = pats.pin_memory(), lens.pin_memory()
    return (pats.to(dev, non_blocking=True), lens.to(dev, non_blocking=True))


def batch_ranges(index, batch: QueryBatch, *,
                 staged=None) -> tuple[np.ndarray, np.ndarray]:
    """Resolve every pattern in `batch` to its `[lo, hi)` SA-rank range.

    One vectorised search for the whole batch; returns two
    int64[n_queries] numpy arrays (padding rows sliced off). An empty index
    maps every pattern to (0, 0). Pass `staged=stage_batch(...)` to run
    against buffers whose copy was already started.
    """
    batch.check_bound_to(index)
    k = batch.n_queries
    if index.n == 0 or k == 0:
        z = np.zeros(k, np.int64)
        return z, z.copy()
    text_d, sa_d = index._device_state()
    pats_d, lens_d = staged if staged is not None else stage_batch(index,
                                                                   batch)
    lo, hi = _ranges_kernel(text_d, sa_d, pats_d, lens_d)
    both = torch.stack([lo[:k], hi[:k]]).cpu().numpy()
    return both[0], both[1]
