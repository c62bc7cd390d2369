"""Sparse suffix-array construction: sampled heads + stride doubling.

The port of `repro.sparse.construct`. `build_sparse_suffix_array(text, s)`
returns the text positions ``{0, s, 2s, ...}`` sorted by the
lexicographic order of their full suffixes: exactly the dense SA
restricted to sampled positions.

1. **Head sort.** The s-char windows at multiples of s do not overlap, so
   the sampled text is the padded text viewed as [ns, s]. Columns are
   packed most-significant-first into int64 words of at most 63 bits
   (`repro_torch.core.words.pack_words`) and ordered by `radix_argsort`,
   the LSD radix sort on the histogram and scatter kernels.
2. **Stride doubling.** Sampled position ``i·s + h·s`` is the sampled
   index ``i + h``, so ties refine like prefix doubling in sampled units:
   round h re-sorts the slots of every tie run by (run id, rank of the
   suffix h samples later, −1 past the end), packed into one word and
   sorted by `radix_argsort`. h doubles until no ties remain.

Every tensor stays on the build's device. The host reads one number per
doubling round, the tie count, which sizes the compaction.

Spans (`repro_torch.trace`): ``repro_torch.sparse.construct`` over the
whole build, ``repro_torch.sparse.heads`` over step 1 and one
``repro_torch.sparse.double`` a round of step 2 that found ties. Counters:
``repro_torch.sparse.rounds`` (those rounds) and
``repro_torch.sparse.tied_rows`` (the tie counts the rounds read).

`sparse_lcp` computes the companion sparse LCP array on the host (numpy,
as the reference does); the index computes it lazily, off the query path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compat import resolve_device
from ..core.words import compact, pack_words, run_state
from ..kernels.ops import dense_rank_gathered, radix_argsort
from ..trace import count, span

I64 = torch.int64


def sampled_positions(n: int, sample_rate: int) -> np.ndarray:
    """The indexed text positions: every `sample_rate`-th, as int64."""
    return np.arange(0, max(int(n), 0), int(sample_rate), dtype=np.int64)


def _sampled_head_words(text: torch.Tensor, ns: int,
                        s: int) -> tuple[list[torch.Tensor], list[int]]:
    """Pack the non-overlapping s-char head windows into int64 words.

    Window i covers text[i*s : (i+1)*s]; the text is padded to ns*s with
    −1 (below every real character, so a window that runs past the end
    compares smaller at its first padded column). Values are shifted to
    non-negative and packed by `core.words.pack_words`, so comparing word
    lists lexicographically equals comparing windows. Returns (words, the
    bit width of each word)."""
    lo = -1
    hi = int(text.max()) if len(text) else 0
    xp = torch.full((ns * s,), lo, dtype=I64, device=text.device)
    xp[:len(text)] = text
    cols = xp.view(ns, s) - lo
    bits = max(1, int(hi - lo).bit_length())
    return pack_words((cols[:, c] for c in range(s)), [bits] * s)


def build_sparse_suffix_array(text, sample_rate: int,
                              device="cuda") -> torch.Tensor:
    """Sampled positions sorted by full-suffix order: int32[ceil(n/s)] on
    `device` (``"cuda"`` unless the caller asks for ``"cpu"``).

    Output[k] is the k-th smallest sampled suffix's text position (a
    multiple of `sample_rate`), comparable with the dense SA filtered to
    multiples of s. `sample_rate` must be ≥ 2: s = 1 is the dense path."""
    s = int(sample_rate)
    if s < 2:
        raise ValueError(
            f"sample_rate must be ≥ 2 for sparse construction, got {s} "
            f"(s = 1 is the dense path: repro_torch.api.build_suffix_array)")
    dev = resolve_device(device)
    with span("repro_torch.sparse.construct"):
        return _construct(text, s, dev)


def _construct(text, s: int, dev: torch.device) -> torch.Tensor:
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.asarray(text, np.int64))
    text = text.to(dev, I64).reshape(-1)
    n = len(text)
    if n and int(text.min()) < 0:
        raise ValueError("text values must be ≥ 0")
    ns = -(-n // s)                       # ceil(n / s) sampled positions
    if ns == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)

    with span("repro_torch.sparse.heads"):
        words, widths = _sampled_head_words(text, ns, s)
        perm = radix_argsort(words, widths)
        head_rank, is_start, _ = dense_rank_gathered(words, perm)
        rank = torch.empty(ns, dtype=I64, device=dev)
        rank[perm] = head_rank.long()

    # Stride doubling in sampled units: round h refines ties by the rank h
    # samples (h·s characters) later; ranks reflect 2h·s characters after
    # the round, so h ≥ ns/2 settles every pair, prefix-equal ones
    # shortest-first through the −1 past-the-end key. Run ids and keys + 1
    # are both below 2**kb, so (run id, key) packs into one word of 2·kb
    # bits.
    kb = ns.bit_length()
    h = 1
    while h < ns:
        _, sizes = run_state(is_start)
        tied = sizes > 1
        u = int(tied.sum())
        if u == 0:
            break
        count("repro_torch.sparse.rounds")
        count("repro_torch.sparse.tied_rows", u)
        with span("repro_torch.sparse.double"):
            sl = compact(tied, u)             # slots inside tie runs
            run_id = torch.cumsum(is_start, 0) - 1
            key2 = torch.full((ns,), -1, dtype=I64, device=dev)
            key2[:ns - h] = rank[h:]
            p = perm[sl]
            packed = (run_id[sl] << kb) | (key2[p] + 1)
            local = radix_argsort([packed], 2 * kb)
            perm[sl] = p[local]
            pk = packed[local]
            is_start[sl[1:]] = pk[1:] != pk[:-1]
            rank[perm] = torch.cumsum(is_start, 0) - 1
        h *= 2
    return (perm * s).to(torch.int32)


def sparse_lcp(text, sparse_sa, *, chunk: int = 64) -> np.ndarray:
    """LCP of consecutive sparse-SA suffixes — int64[len(sparse_sa)].

    ``out[k]`` (k ≥ 1) is the longest common prefix, in characters, of
    the suffixes at ``sparse_sa[k-1]`` and ``sparse_sa[k]``; ``out[0]`` is
    0, the dense Kasai layout. Host numpy: every still-tied pair advances
    `chunk` characters a round, O(Σ lcp + ns·chunk) work in all."""
    text = np.asarray(text, np.int64).ravel()
    ssa = np.asarray(sparse_sa, np.int64).ravel()
    n, ns = len(text), len(ssa)
    out = np.zeros(ns, np.int64)
    if ns < 2:
        return out
    a, b = ssa[:-1], ssa[1:]
    active = np.arange(ns - 1, dtype=np.int64)
    off = np.zeros(ns - 1, np.int64)
    step = np.arange(chunk, dtype=np.int64)
    while len(active):
        ia = (a[active] + off[active])[:, None] + step[None, :]
        ib = (b[active] + off[active])[:, None] + step[None, :]
        # distinct past-the-end sentinels: two suffixes ending at the same
        # offset stop matching there, and a suffix never matches the
        # other's real character past its own end
        va = np.where(ia < n, text[np.minimum(ia, n - 1)], np.int64(-1))
        vb = np.where(ib < n, text[np.minimum(ib, n - 1)], np.int64(-2))
        eq = va == vb
        matched = np.where(eq.all(axis=1), chunk, np.argmax(~eq, axis=1))
        out[active + 1] += matched
        off[active] += matched
        active = active[matched == chunk]
    return out
