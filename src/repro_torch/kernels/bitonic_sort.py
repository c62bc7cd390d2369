"""Launch schedule and launchers of the shared-memory bitonic row sort
(`csrc/bitonic_sort.cu`).

A bitonic sort of int32[N, W] rows (N a power of two) is the stages (k, j),
k = 2, 4, .. N and, for each k, j = k/2 .. 1, in that order. `schedule`
groups consecutive stages into launches whose row pairs all lie inside one
CUDA block's rows, so that a launch reads and writes every row once:

* a ``tile`` launch holds tiles of T consecutive rows: the first one runs
  every stage with k <= T (it sorts each tile), and one more for each
  k > T runs the stages j = T/2 .. 1 of that k;
* a ``cross`` launch runs up to r consecutive levels j >= T of one k: a
  block holds 2^r runs of T / 2^r consecutive rows, j_lo rows apart.

T is the largest power of two whose rows, at a pitch of W | 1 words, fit
`SMEM_BUDGET` bytes of shared memory; r is at most log2(T / C), with C
the fewest rows that make a run of `MIN_RUN_BYTES`. At W = 4 and N = 2^24
that is T = 4096, C = 32, r <= 7 and 30 launches in place of 300 stages.

`ops.bitonic_sort` follows this schedule on every device: a CUDA tensor
runs each launch on the kernel, a CPU tensor applies its stages one by one
with `ref.bitonic_stages_ref`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ._build import LAUNCHES, check, library
from .bitonic_stage import check_rows

#: shared memory a block of the sort may use (two blocks fit an H100 SM);
#: equal to `kSmemBudget` in csrc/bitonic_sort.cu.
SMEM_BUDGET = 112 * 1024
#: the shortest run of consecutive rows a cross-tile block reads.
MIN_RUN_BYTES = 512


def _log2(x: int) -> int:
    return x.bit_length() - 1


@dataclass(frozen=True)
class Launch:
    """One launch of the sort: stages (k, j) for k = k_first .. k_last and
    j = min(k / 2, j_hi) .. j_lo, on blocks of `rows` rows made of runs of
    `run` consecutive rows."""
    kind: str        # "tile" or "cross"
    k_first: int
    k_last: int
    j_hi: int
    j_lo: int
    rows: int
    run: int

    def stages(self) -> list[tuple[int, int]]:
        out = []
        k = self.k_first
        while k <= self.k_last:
            j = min(k // 2, self.j_hi)
            while j >= self.j_lo:
                out.append((k, j))
                j //= 2
            k *= 2
        return out


def tile_rows(n: int, w: int) -> int:
    """T: the largest power of two of rows, at most `n`, whose pitch-(w | 1)
    rows fit `SMEM_BUDGET`."""
    fit = SMEM_BUDGET // (4 * (w | 1))
    if fit < 2:
        raise ValueError(f"bitonic_sort: W={w} is too wide for a "
                         f"{SMEM_BUDGET}-byte tile of two rows")
    return min(1 << _log2(fit), n)


def schedule(n: int, w: int) -> list[Launch]:
    """The launches of a sort of int32[n, w] rows, n a power of two."""
    if n < 2:
        return []
    t = tile_rows(n, w)
    run = 1
    while run * w * 4 < MIN_RUN_BYTES and run < t // 2:
        run *= 2
    r_max = _log2(t // run)
    out = [Launch("tile", 2, t, t // 2, 1, t, t)]
    k = 2 * t
    while k <= n:
        j = k // 2
        while j >= t:
            r = min(r_max, _log2(j // t) + 1)
            out.append(Launch("cross", k, k, j, j >> (r - 1), t, t >> r))
            j >>= r
        out.append(Launch("tile", k, k, t // 2, 1, t, t))
        k *= 2
    return out


def bitonic_launch_cuda(rows: torch.Tensor, launch: Launch,
                        num_keys: int) -> torch.Tensor:
    """Run one launch of `schedule` in place on the current stream.
    Returns `rows`."""
    n, w = check_rows(rows, f"bitonic_{launch.kind}")
    if n & (n - 1) or n % launch.rows:
        raise ValueError(f"bitonic_{launch.kind}: N={n} is not a power of "
                         f"two holding {launch.rows}-row blocks")
    if launch.rows * (w | 1) * 4 > SMEM_BUDGET:
        raise ValueError(f"bitonic_{launch.kind}: {launch.rows} rows of "
                         f"W={w} exceed {SMEM_BUDGET} bytes")
    if not 1 <= num_keys <= w:
        raise ValueError(f"bitonic_{launch.kind}: num_keys={num_keys} "
                         f"outside [1, {w}]")
    dev, stream = rows.device.index, torch.cuda.current_stream(
        rows.device).cuda_stream
    if launch.kind == "tile":
        status = library().repro_bitonic_tile(
            rows.data_ptr(), n, w, num_keys, _log2(launch.rows),
            launch.k_first, launch.k_last, dev, stream)
    else:
        r = _log2(launch.j_hi // launch.j_lo) + 1
        status = library().repro_bitonic_cross(
            rows.data_ptr(), n, w, num_keys, launch.k_first, launch.j_hi, r,
            _log2(launch.run), dev, stream)
    name = f"bitonic_{launch.kind}"
    check(status, name)
    LAUNCHES[name] += 1
    return rows
