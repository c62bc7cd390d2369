"""Difference covers of Z_v and the Lemma-1 offset tables.

A set D ⊆ Z_v is a *difference cover* of Z_v if every z ∈ Z_v can be written as
z ≡ a - b (mod v) with a, b ∈ D.  The paper (Pace & Tiskin 2013, §2) requires
|D| < v and 0 ∉ D (so that the last super-character of each X_k block ends with
a -1 sentinel, see §3 Step 1).

Constructions
-------------
* exact optimal covers for small v (from the literature / brute force),
* the O(√v) "run ∪ stride" construction for arbitrary v:
      D0 = [0:r) ∪ {0, r, 2r, ...}  with r = ceil(sqrt(v))
  which is a difference cover because any z ∈ Z_v decomposes as z = q·r - s with
  q·r < v + r and s ∈ [0:r); |D0| ≤ 2√v + 2 = O(√v), matching the paper's
  asymptotics (the Colbourn–Ling series achieves ≈ √(1.5 v) but is only defined
  at specific moduli; EXPERIMENTS C2 compares the sizes).
* a greedy pruning pass that removes redundant elements while preserving the
  cover property (keeps sizes close to CL's in practice).

0 ∉ D is enforced by the shift trick from the paper: for any fixed z,
D' = {(d - z) mod v | d ∈ D} is still a difference cover.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

# Known-good small covers (0-free where possible; shifted later anyway).
# v: cover. Optimal sizes: v=3:2, v=4:3, v=5:3 (paper: |D|>=... table2 says 4
# for 5..13 via CL; the true optimum for v=5 is 3: {1,2,4} ... differences:
# 1-2=-1=4? {1,2,4}: pairwise diffs mod 5: {0,1,2,3,4} yes (4-1=3, 1-4=-3=2,
# 2-1=1, 1-2=4, 4-2=2...). We verify everything at construction time.
_EXACT_COVERS = {
    3: [1, 2],
    4: [1, 2, 3],
    5: [1, 2, 4],
    7: [1, 2, 4],
    9: [1, 2, 4, 7],
    13: [1, 2, 4, 10],
    21: [1, 2, 5, 15, 17],
    31: [1, 2, 4, 9, 13, 19],
    32: [1, 2, 4, 9, 13, 19],  # cover of 31 works? verified at import below.
    64: [1, 2, 4, 9, 13, 19, 24, 31, 52],
}


def is_difference_cover(D, v: int) -> bool:
    """Check that D covers Z_v: ∀z∈[0,v) ∃a,b∈D: z ≡ a-b (mod v)."""
    D = np.asarray(sorted(set(int(d) % v for d in D)), dtype=np.int64)
    if len(D) == 0:
        return False
    diffs = (D[:, None] - D[None, :]) % v
    return len(np.unique(diffs)) == v


def _run_stride_cover(v: int) -> list[int]:
    """O(√v) construction: [0:r) ∪ {0, r, 2r, ...}, r = ceil(sqrt(v))."""
    r = int(np.ceil(np.sqrt(v)))
    D = set(range(r)) | set(range(0, v, r))
    return sorted(D)


def _greedy_prune(D: list[int], v: int) -> list[int]:
    """Remove elements while the set remains a difference cover (stable)."""
    D = list(D)
    # Try removing largest-first; keeps the small run elements that carry
    # most coverage.
    for d in sorted(D, reverse=True):
        trial = [x for x in D if x != d]
        if len(trial) >= 2 and is_difference_cover(trial, v):
            D = trial
    return D


def _shift_zero_free(D: list[int], v: int) -> list[int]:
    """Shift D so that 0 ∉ D (paper §2: D' = {(d-z) mod v} is still a cover)."""
    if 0 not in D:
        return sorted(D)
    for z in range(1, v):
        shifted = sorted((d - z) % v for d in D)
        if 0 not in shifted:
            return shifted
    raise ValueError(f"no zero-free shift exists for D={D}, v={v}")  # |D|=v only


@functools.lru_cache(maxsize=None)
def difference_cover(v: int) -> tuple[int, ...]:
    """Return a 0-free difference cover of Z_v with |D| = O(√v), |D| < v.

    Requires v >= 3 (paper §2).
    """
    if v < 3:
        raise ValueError(f"difference cover requires v >= 3, got {v}")
    if v in _EXACT_COVERS and is_difference_cover(_EXACT_COVERS[v], v):
        D = list(_EXACT_COVERS[v])
    else:
        D = _run_stride_cover(v)
        if v <= 4096:  # pruning is O(v·|D|²)-ish; cheap at these sizes
            D = _greedy_prune(D, v)
    D = _shift_zero_free(D, v)
    assert is_difference_cover(D, v), (v, D)
    assert 0 not in D and len(D) < v
    return tuple(int(d) for d in D)


def cover_size_lower_bound(v: int) -> float:
    """|D| ≥ (1+√(4v−3))/2 (paper §2: |D|(|D|−1)+1 ≥ v)."""
    return (1.0 + np.sqrt(4.0 * v - 3.0)) / 2.0


@dataclass(frozen=True)
class CoverTables:
    """Precomputed lookup tables for one (v, D) pair.

    Attributes
    ----------
    v : modulus
    D : the difference cover (sorted, 0-free)
    in_D : bool[v], in_D[k] = k ∈ D
    shifts : int32[v, |D|]; shifts[k] = sorted {l ∈ [0:v) : (k+l) mod v ∈ D}.
        For every class k there are exactly |D| such offsets.
    lam : int32[v, v]; lam[k1, k2] = min l such that (k1+l) mod v ∈ D and
        (k2+l) mod v ∈ D  — the Lemma-1 offset. Always < v.
    lam_idx1 / lam_idx2 : int32[v, v]; position of lam[k1,k2] within
        shifts[k1] / shifts[k2] — lets a payload that carries
        rank[i + shifts[k][j]] for j ∈ [0:|D|) look up the Lemma-1 rank by
        *local index* instead of by offset.
    """

    v: int
    D: tuple[int, ...]
    in_D: np.ndarray
    shifts: np.ndarray
    lam: np.ndarray
    lam_idx1: np.ndarray
    lam_idx2: np.ndarray


@functools.lru_cache(maxsize=None)
def cover_tables(v: int) -> CoverTables:
    D = difference_cover(v)
    dsize = len(D)
    in_D = np.zeros(v, dtype=bool)
    in_D[list(D)] = True

    # shifts[k] = all l with (k+l) mod v ∈ D
    shifts = np.zeros((v, dsize), dtype=np.int32)
    for k in range(v):
        ls = [l for l in range(v) if in_D[(k + l) % v]]
        assert len(ls) == dsize
        shifts[k] = ls

    # Lemma 1: for any k1,k2 there is l with both (k1+l),(k2+l) ∈ D.
    lam = np.full((v, v), -1, dtype=np.int32)
    lam_idx1 = np.full((v, v), -1, dtype=np.int32)
    lam_idx2 = np.full((v, v), -1, dtype=np.int32)
    shift_sets = [set(int(x) for x in shifts[k]) for k in range(v)]
    for k1 in range(v):
        for k2 in range(v):
            common = shift_sets[k1] & shift_sets[k2]
            assert common, f"Lemma 1 violated for v={v}, D={D}, k=({k1},{k2})"
            l = min(common)
            lam[k1, k2] = l
            lam_idx1[k1, k2] = int(np.where(shifts[k1] == l)[0][0])
            lam_idx2[k1, k2] = int(np.where(shifts[k2] == l)[0][0])

    return CoverTables(
        v=v, D=D, in_D=in_D, shifts=shifts, lam=lam,
        lam_idx1=lam_idx1, lam_idx2=lam_idx2,
    )


# Verify the tabulated exact covers once at import (cheap) so a bad entry can
# never be silently used — invalid entries fall through to run∪stride.
for _v, _D in list(_EXACT_COVERS.items()):
    if not is_difference_cover(_D, _v):
        del _EXACT_COVERS[_v]
