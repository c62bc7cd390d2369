"""Plain PyTorch versions of the kernels in `repro_torch.kernels`.

One per kernel, with the contracts of `repro.kernels.ref` where the TPU
kernel has one. They run on any device: the CPU path of every wrapper in
`repro_torch.kernels.ops` runs them, and on the card they are what each
kernel is held against. `lsd_argsort` is the LSD radix sort's driver,
shared by `radix_argsort_ref` (these plain versions) and
`ops.radix_argsort` (the kernels on a CUDA tensor).
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

#: one LSD pass sorts this many key bits: 256 digits.
RADIX_BITS = 8
RADIX_BINS = 1 << RADIX_BITS
#: elements per block of the radix sort's histogram and scatter passes.
SORT_BLOCK = 4096


def _lex_lt(a: torch.Tensor, b: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Row-wise strict lexicographic a < b over the first num_keys columns."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for c in range(num_keys):
        lt |= eq & (a[..., c] < b[..., c])
        eq &= a[..., c] == b[..., c]
    return lt


def bitonic_stage_ref(rows: torch.Tensor, k: int, j: int,
                      num_keys: int | None = None) -> torch.Tensor:
    """One bitonic compare-exchange stage (k, j) over rows [N, W]: row i
    pairs with row i^j, ascending iff (i & k) == 0, and keeps its own value
    iff (lt(self, partner) == self_is_lower) == ascending."""
    n, w = rows.shape
    num_keys = num_keys or w
    idx = torch.arange(n, device=rows.device)
    partner = idx ^ j
    other = rows[partner]
    up = (idx & k) == 0
    lower = idx < partner
    keep = (_lex_lt(rows, other, num_keys) == lower) == up
    return torch.where(keep[:, None], rows, other)


def bitonic_stages_ref(rows: torch.Tensor, stages,
                       num_keys: int | None = None) -> torch.Tensor:
    """The stages (k, j) of `stages`, in order, each one
    `bitonic_stage_ref`: what one launch of the shared-memory sort
    (`csrc/bitonic_sort.cu`) computes."""
    for k, j in stages:
        rows = bitonic_stage_ref(rows, k, j, num_keys)
    return rows


def bitonic_sort_ref(rows: torch.Tensor,
                     num_keys: int | None = None) -> torch.Tensor:
    """Oracle: rows stably sorted by their first num_keys columns (stable
    passes from the last key to the first, as `numpy.lexsort` orders)."""
    num_keys = num_keys or rows.shape[1]
    order = torch.arange(rows.shape[0], device=rows.device)
    for c in reversed(range(num_keys)):
        order = order[torch.sort(rows[order, c], stable=True).indices]
    return rows[order]


def seg_boundary_ref(rows: torch.Tensor, num_keys: int | None = None,
                     block: int = 512):
    """Sorted rows [N, W], N a multiple of block -> (flags int32[N],
    csum int32[N], totals int32[N // block]): flag[i] marks row i differing
    from row i-1 on the first num_keys columns, with the first row of every
    block forced to 1; csum is the block-inclusive prefix sum of the flags,
    totals the per-block flag count."""
    n, w = rows.shape
    num_keys = num_keys or w
    keys = rows[:, :num_keys]
    prev = torch.cat([keys[:1], keys[:-1]], dim=0)
    neq = (keys != prev).any(dim=1).reshape(n // block, block)
    neq[:, 0] = True
    flags = neq.reshape(-1).to(torch.int32)
    csum = torch.cumsum(neq, dim=1, dtype=torch.int32).reshape(-1)
    totals = neq.sum(dim=1, dtype=torch.int32)
    return flags, csum, totals


def dense_rank_rows_ref(rows: torch.Tensor, num_keys: int | None = None):
    """Dense ranks of rows [N, W] sorted by their first num_keys columns:
    (ranks int32[N], n_distinct int32 0-d). Row i starts a run iff it
    differs from row i-1 there (row 0 always does); ranks[i] is the number
    of run starts up to i, less one."""
    num_keys = num_keys or rows.shape[1]
    keys = rows[:, :num_keys]
    start = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    start[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    return (torch.cumsum(start, 0, dtype=torch.int32) - 1,
            start.sum(dtype=torch.int32))


def rows_neq(words: Sequence[torch.Tensor], pa: torch.Tensor,
             pb: torch.Tensor) -> torch.Tensor:
    """Element-wise "row at pa differs from row at pb", a row being the
    tuple of `words` at one position: two gathers and a compare a word."""
    neq = words[0][pa] != words[0][pb]
    for w in words[1:]:
        neq |= w[pa] != w[pb]
    return neq


def dense_rank_gathered_ref(words: Sequence[torch.Tensor],
                            pos: torch.Tensor):
    """Dense ranks of the rows (words[0][pos[i]], ..., words[K-1][pos[i]])
    in the order of `pos`, which must sort them: (ranks int32[N], is_start
    bool[N], n_distinct int32 0-d), is_start[i] marking row i != row i-1
    (is_start[0] True) and ranks = cumsum(is_start) - 1."""
    is_start = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    is_start[1:] = rows_neq(words, pos[1:], pos[:-1])
    return (torch.cumsum(is_start, 0, dtype=torch.int32) - 1, is_start,
            is_start.sum(dtype=torch.int32))


def radix_histogram_ref(digits: torch.Tensor, n_bins: int,
                        block: int) -> torch.Tensor:
    """Per-block histograms: int32[N] digits, N a multiple of `block` ->
    int32[N // block, n_bins], row b counting block b's digits equal to each
    bin. Digits outside [0, n_bins) count nowhere (the one-hot rule of
    `repro.kernels.ref.radix_histogram_ref`)."""
    n = digits.shape[0]
    if n % block:
        raise ValueError(f"radix_histogram_ref: N={n} is not a multiple of "
                         f"block={block}")
    nb = n // block
    pos = torch.arange(n, device=digits.device)
    valid = (digits >= 0) & (digits < n_bins)
    slot = torch.where(valid, pos // block * n_bins + digits, nb * n_bins)
    out = torch.zeros(nb * n_bins + 1, dtype=torch.int32,
                      device=digits.device)
    out.scatter_add_(0, slot, torch.ones_like(digits, dtype=torch.int32))
    return out[:-1].view(nb, n_bins)


def radix_scatter_ref(keys: torch.Tensor, payload: torch.Tensor, shift: int,
                      offsets: torch.Tensor, block: int, *,
                      write_keys: bool = True):
    """One stable counting pass by the digit d = (key >> shift) & 255.

    Element i goes to ``offsets[d, i // block]`` plus its rank among the
    elements before it in its block with the same digit; `offsets` is
    int[256, ceil(N / block)]. Step by step: a stable sort by (digit, block)
    lists every (digit, block) group in element order, so an element's rank
    in its group is its sorted slot minus the group's first slot. Returns
    (keys_out or None, payload_out)."""
    n = keys.shape[0]
    nb = -(-n // block)
    pos = torch.arange(n, device=keys.device)
    group = ((keys >> shift) & (RADIX_BINS - 1)) * nb + pos // block
    grp_sorted, by_group = torch.sort(group, stable=True)
    rank = pos - torch.searchsorted(grp_sorted, grp_sorted)
    dest = torch.empty_like(pos)
    dest[by_group] = offsets.reshape(-1)[grp_sorted].long() + rank
    payload_out = torch.empty_like(payload)
    payload_out[dest] = payload
    if not write_keys:
        return None, payload_out
    keys_out = torch.empty_like(keys)
    keys_out[dest] = keys
    return keys_out, payload_out


def radix_pass_counts_ref(keys: torch.Tensor, shift: int,
                          block: int) -> torch.Tensor:
    """One LSD pass's digit counts, bin-major and led by a zero: int64[N]
    non-negative `keys` -> int32[256 * nb + 1], nb = ceil(N / block), with
    element 0 equal to 0 and element 1 + d * nb + b the number of keys of
    block b (positions b * block .. (b + 1) * block - 1 below N) whose
    digit (key >> shift) & 255 is d. Its inclusive cumsum holds at
    d * nb + b the exclusive bin-major offsets that `radix_scatter_ref`
    takes."""
    n = keys.shape[0]
    nb = -(-n // block)
    pos = torch.arange(n, device=keys.device)
    slot = 1 + ((keys >> shift) & (RADIX_BINS - 1)) * nb + pos // block
    out = torch.zeros(RADIX_BINS * nb + 1, dtype=torch.int32,
                      device=keys.device)
    return out.scatter_add_(0, slot, torch.ones_like(slot,
                                                     dtype=torch.int32))


def lsd_argsort(words: Sequence[torch.Tensor], key_bits, count: Callable,
                scatter: Callable, block: int = SORT_BLOCK) -> torch.Tensor:
    """Stable LSD radix argsort of int64 word lists, most significant word
    first: the order that sorts positions by (words[0], words[1], ...,
    position).

    Every word must be non-negative and below 2**key_bits (`key_bits` is
    one int for all words or one per word, at most 63), so the pass count,
    ceil(key_bits / 8) per word, is known on the host. Each pass counts the
    8-bit digits of each `block` straight from the keys with
    ``count(keys, shift, block)`` (the zero-led bin-major counts of
    `radix_pass_counts_ref`), turns them into start offsets with one
    inclusive cumsum, and moves keys and an int32 position payload with
    ``scatter(keys, payload, shift, offsets, block, write_keys=)``.
    Returns int64[N] on the words' device."""
    n = words[0].shape[0]
    device = words[0].device
    bits = ([int(key_bits)] * len(words) if isinstance(key_bits, int)
            else [int(b) for b in key_bits])
    if len(bits) != len(words) or any(not 0 <= b <= 63 for b in bits):
        raise ValueError(f"key_bits {key_bits} must give each of the "
                         f"{len(words)} words a width in [0, 63]")
    if n >= 2 ** 31:
        raise ValueError(f"lsd_argsort: N={n} needs int32 positions")
    order = torch.arange(n, dtype=torch.int32, device=device)
    if n <= 1:
        return order.long()
    nb = -(-n // block)
    scan = torch.empty(RADIX_BINS * nb + 1, dtype=torch.int32, device=device)
    offsets = scan[:RADIX_BINS * nb].view(RADIX_BINS, nb)
    first = True
    for word, width in zip(reversed(words), reversed(bits)):
        passes = -(-width // RADIX_BITS)
        if not passes:
            continue
        keys = word.contiguous() if first else word[order]
        first = False
        for p in range(passes):
            shift = p * RADIX_BITS
            torch.cumsum(count(keys, shift, block), 0, dtype=torch.int32,
                         out=scan)
            keys, order = scatter(keys, order, shift, offsets, block,
                                  write_keys=p + 1 < passes)
    return order.long()


def radix_argsort_ref(words: Sequence[torch.Tensor], key_bits,
                      block: int = SORT_BLOCK) -> torch.Tensor:
    """`ops.radix_argsort` on the plain versions: the same LSD driver
    (`lsd_argsort`) with `radix_pass_counts_ref` and `radix_scatter_ref`."""
    return lsd_argsort(words, key_bits, radix_pass_counts_ref,
                       radix_scatter_ref, block)


def lemma1_merge_ref(p: torch.Tensor, klass: torch.Tensor,
                     rvals: torch.Tensor, lane: torch.Tensor,
                     width: torch.Tensor, lam1: torch.Tensor,
                     lam2: torch.Tensor) -> torch.Tensor:
    """Place the rows of every tie group in Lemma-1 comparator order.

    `p` (int64[U]) are the rows' positions, `klass` their classes, `rvals`
    (int64[U, |D|]) their sample ranks and `lam1` / `lam2` (int64[v, v])
    the Lemma-1 column tables. Row j precedes row i, of classes b and a,
    iff (rvals[j, lam1[b, a]], p[j]) < (rvals[i, lam2[b, a]], p[i]).

    The rows come sorted by (group, class, key, p), the key of a class-k
    row being rvals[i, lam1[k, k]]; row i's group holds the slice
    [i - lane[i], i - lane[i] + width[i]) (here one searchsorted over
    (group, class) finds every class segment, and the widest group bounds
    the binary searches' steps). Row i
    of class a lands at its group's start plus, for each class b, the
    number of the group's class-b rows that precede it: for b = a its
    offset in its own class segment, for b != a a binary search of the
    class-b segment, which the key order also orders by that comparator.
    Returns int64[U]: the
    positions p in their slots. Where the ranks follow no suffix order (a
    failed exchange's), destinations may collide; a slot left unwritten
    keeps the p it held, so every entry stays a position of its group."""
    n = p.shape[0]
    v = lam1.shape[0]
    idx = torch.arange(n, device=p.device)
    start = idx - lane
    seg = start * v + klass                 # ascending: (group, class)
    dest = start.clone()
    steps = int(width.max()).bit_length() if n else 0   # a segment's search
    for b in range(v):
        first = torch.searchsorted(seg, start * v + b)
        lo = first
        hi = torch.searchsorted(seg, start * v + b + 1)
        col = lam1[b, klass]
        target = rvals.gather(1, lam2[b, klass][:, None])[:, 0]
        for _ in range(steps):
            active = lo < hi
            mid = (lo + hi) // 2
            j = mid.clamp(max=n - 1)
            c = rvals[j, col]
            before = active & ((c < target) | ((c == target) & (p[j] < p)))
            lo = torch.where(before, mid + 1, lo)
            hi = torch.where(active & ~before, mid, hi)
        dest += torch.where(klass == b, idx - first, lo - first)
    out = p.clone()
    out[dest] = p
    return out


def encode_place_ref(flat: torch.Tensor,
                     ends: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sentinel-separator text of a corpus from its documents' tokens.

    `flat` (int64[N]) holds the documents back to back and `ends`
    (int64[D], non-decreasing, ``ends[-1] == N``) their cumulative ends.
    Data token j of document k lands at ``j + k``, shifted up by D; document
    k's separator, of value k, lands at ``ends[k] + k``, right after its
    last token. Returns ``(text int64[N + D], negative int32[1])``, where
    `negative` is 1 if any token is below 0 and 0 otherwise."""
    d = ends.shape[0]
    seps = ends + torch.arange(d, device=ends.device)
    text = torch.empty(flat.shape[0] + d, dtype=torch.int64,
                       device=flat.device)
    data = torch.ones(text.shape[0], dtype=torch.bool, device=flat.device)
    data[seps] = False
    text[data] = flat + d
    text[seps] = torch.arange(d, device=flat.device)
    return text, (flat < 0).any().to(torch.int32).reshape(1)
