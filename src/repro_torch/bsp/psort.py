"""Algorithm 2 — parallel sorting by regular sampling (Shi–Schaeffer /
Chan–Dehne), generic over key-based and comparator-based orders, with
pluggable rank-local sorts: the port of `repro.bsp.psort`.

Row contract
------------
Rows are int32[m_local, W] with a fixed column layout:
  col 0      : valid flag (0 = valid, 1 = pad)  — pads sort last,
  col 1..W-2 : payload (keys first for key-mode),
  col W-1    : unique global index — strict total-order tiebreak.
`lt_fn(a, b) -> bool[N]` must be a strict total order consistent with that
contract; `local_sort(rows) -> rows` must sort by the same order. Since the
index column breaks every tie, any correct sort gives the same rows.

Local-sort implementations (`sort_impl` of the bsp backend)
----------------------------------------------------------
==========  ===============================================================
"radix"     packed keys: the key columns are packed into as few 30-bit
            int32 lanes as their value range allows (`pack_key_columns`),
            and every key sort (`argsort_rows`) runs on `radix_argsort`,
            the LSD radix sort on the hand-written histogram and scatter
            kernels (their plain versions on a CPU tensor). A Lemma-1
            comparator tail (`make_local_sort_keyed`) runs only when the
            key sort left equal-key runs of valid rows.
"torch"     the same two-phase sort over the raw (unpacked) key columns,
            each key sort by stable `torch.sort` (the reference's "lax").
"bitonic"   the legacy comparator network over full payload rows
            (`make_local_sort_bitonic`) — O(m log² m) compare-exchanges
            with the Lemma-1 comparator at every stage.
==========  ===============================================================

Supersteps per call: 6 (sample gather, 2×a2a bucket exchange, count gather,
2×a2a rebalance) — O(1) as in the paper. Communication per rank:
O(m_local + p²) words.
"""
from __future__ import annotations

import torch

from ..core.bitonic import bitonic_sort, lex_lt_int, next_pow2
from ..core.words import (argsort_words, compact, lemma1_order, pack_words,
                          run_state)
from ..launch.mesh import all_gather, mesh_num_devices
from .exchange import exchange
from .primitives import INT32_MAX, lex_lt_rows, searchsorted_rows

#: accepted bsp `sort_impl` values ("auto" resolves via
#: `resolve_bsp_sort_impl`; the torch backend's "kernel" is rejected).
BSP_SORT_IMPLS = ("auto", "radix", "torch", "bitonic")
#: the payload's rank columns are int32: every rank lies in [-1, 2³¹).
RANK_BOUND = 2 ** 31


def resolve_bsp_sort_impl(sort_impl: str, pack_keys: bool = True) -> str:
    """Concrete rank-local sort implementation for the bsp backend.

    ``"auto"`` resolves to the packed-key path (``"radix"``) unless key
    packing is disabled (`pack_keys=False`), then to the unpacked multi-key
    sort (``"torch"``). ``"kernel"`` (the torch backend's bitonic window
    sort, the counterpart of the reference's "pallas") has no bsp
    counterpart and is rejected, as the reference rejects "pallas"."""
    if sort_impl == "auto":
        return "radix" if pack_keys else "torch"
    if sort_impl not in BSP_SORT_IMPLS:
        raise ValueError(
            f"sort_impl {sort_impl!r} is not supported by the bsp backend; "
            f"expected one of {BSP_SORT_IMPLS}")
    return sort_impl


def key_sort_of(impl: str) -> str:
    """The key-sort family of a resolved impl: ``"torch"`` sorts keys with
    `torch.sort`; "radix" and "bitonic" (whose SM1 packs like "radix")
    with `radix_argsort`."""
    return "torch" if impl == "torch" else "radix"


# --------------------------------------------------------------------------
# key packing
# --------------------------------------------------------------------------
def pack_key_columns(cols: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Pack integer key columns with a known value range into 30-bit lanes.

    cols int[m, k] with every value in [lo, hi] → int32[m, ⌈k/per⌉] where
    `per = ⌊30 / bits⌋` fixed-width fields of `bits = bit_length(hi - lo)`
    are packed big-endian into each lane: order-preserving (lexicographic
    comparison of the lanes equals that of the columns) and injective.
    Returns `cols` unchanged when a field does not fit at least twice into
    30 bits. 30 bits (not 31) keeps every lane below INT32_MAX, so pad rows
    still sort last."""
    m, k = cols.shape
    span = max(1, int(hi) - int(lo))
    bits = span.bit_length()
    per = max(1, 30 // bits)
    if per < 2:
        return cols
    shifted = (cols - lo).to(torch.int32)
    ncol = -(-k // per)
    pad = ncol * per - k
    if pad:
        shifted = torch.cat([shifted, shifted.new_zeros((m, pad))], dim=1)
    weights = torch.tensor([1 << (bits * (per - 1 - j)) for j in range(per)],
                           dtype=torch.int32, device=cols.device)
    return (shifted.view(m, ncol, per) * weights).sum(-1, dtype=torch.int32)


def packed_width(k: int, lo: int, hi: int) -> int:
    """Number of int32 key lanes `pack_key_columns` produces for k columns."""
    span = max(1, int(hi) - int(lo))
    per = max(1, 30 // span.bit_length())
    return k if per < 2 else -(-k // per)


def quantize_sigma(sigma: int) -> int:
    """Round an alphabet bound up to the largest bound with the same packed
    field width (`bit_length(sigma + 1)` bits for values in [-1, sigma]).
    The reference quantises so that nearby maxima share compiled programs;
    the port keeps the same value so that both pack alike. Always ≥ sigma."""
    return (1 << (int(sigma) + 1).bit_length()) - 2


# --------------------------------------------------------------------------
# pad rows, orders and key sorts
# --------------------------------------------------------------------------
def make_pad_rows(k: int, W: int, tag_base: int = 1 << 29, device=None):
    """Pad rows: valid=1, payload=MAX, unique huge tiebreak index."""
    pad = torch.full((k, W), INT32_MAX, dtype=torch.int32, device=device)
    pad[:, 0] = 1
    pad[:, W - 1] = tag_base + torch.arange(k, dtype=torch.int32,
                                            device=device)
    return pad


def lex_lt_full(a: torch.Tensor, b: torch.Tensor):
    """Default strict total order: lexicographic over ALL columns.

    Strict because col W-1 is unique."""
    return lex_lt_rows(a, b)


def argsort_rows(rows: torch.Tensor, cols, key_sort: str = "radix"):
    """int64[m]: the order that sorts `rows` lexicographically by the
    columns `cols`, ties in row order.

    Each column is offset by its minimum (so signed and INT32_MAX columns
    become non-negative words), constant columns are skipped, and the rest
    are packed most-significant first into as few int64 words of ≤ 63 bits
    as their ranges allow (`core.words.pack_words`; one host read for the
    ranges), then argsorted by `core.words.argsort_words`: ``"radix"``
    with `radix_argsort` (the hand-written kernels on a CUDA tensor),
    ``"torch"`` with stable `torch.sort` passes."""
    m = rows.shape[0]
    if m <= 1:
        return torch.arange(m, device=rows.device)
    sel = rows[:, list(cols)].long()
    lo, hi = torch.aminmax(sel, dim=0)
    widths = [int(span).bit_length() for span in (hi - lo).tolist()]
    keep = [c for c, w in enumerate(widths) if w]   # constants decide nothing
    if not keep:
        return torch.arange(m, device=rows.device)
    words, bits = pack_words((sel[:, c] - lo[c] for c in keep),
                             [widths[c] for c in keep])
    return argsort_words(words, bits, key_sort)


def local_sort_lex(rows: torch.Tensor, key_sort: str = "radix"):
    """Sort rows lexicographically over all columns (the key-mode sort)."""
    return rows[argsort_rows(rows, range(rows.shape[1]), key_sort)]


def make_local_sort_bitonic(lt_fn):
    """The legacy local sort: a comparator-bitonic network (`core.bitonic`)
    over whole rows, padded to a power of two with pad rows."""
    def local_sort(rows: torch.Tensor) -> torch.Tensor:
        m, W = rows.shape
        n2 = next_pow2(m)
        if n2 != m:
            rows = torch.cat([rows, make_pad_rows(n2 - m, W,
                                                  device=rows.device)])
        out = bitonic_sort({"rows": rows},
                           lambda a, b: lt_fn(a["rows"], b["rows"]))
        return out["rows"][:m]
    return local_sort


# --------------------------------------------------------------------------
# Lemma-1 payload order over packed/unpacked keys
# --------------------------------------------------------------------------
def make_payload_lt(nk: int, v: int, dsize: int, lam_i1, lam_i2):
    """Strict total order on Lemma-1 payload rows
    [valid | keys(nk) | ranks(|D|) | klass | gidx].

    The head (valid flag + nk key lanes) is compared lexicographically;
    head-equal rows are resolved by the paper's Lemma-1 rank lookup
    `rank[i + Λ[k_i][k_j]]` via the per-class index tables (int64 [v, v]
    on the rows' device), then by the unique gidx column. `v` bounds the
    klass clip (pads carry INT32_MAX)."""
    cr = 1 + nk
    ck = 1 + nk + dsize
    cg = 2 + nk + dsize

    def lt(a, b):
        ka = a[:, ck].clamp(0, v - 1).long()
        kb = b[:, ck].clamp(0, v - 1).long()
        lt_head, eq_head = lex_lt_int(a[:, :1 + nk], b[:, :1 + nk])
        ra = a[:, cr:cr + dsize].gather(1, lam_i1[ka, kb][:, None])[:, 0]
        rb = b[:, cr:cr + dsize].gather(1, lam_i2[ka, kb][:, None])[:, 0]
        return torch.where(eq_head & (ra != rb), ra < rb,
                           torch.where(eq_head, a[:, cg] < b[:, cg], lt_head))

    return lt


def make_local_sort_keyed(nk: int, v: int, dsize: int, lam_i1, lam_i2,
                          key_sort: str = "radix"):
    """Two-phase rank-local sort by the `make_payload_lt` order.

    Phase 1 is one key sort (`argsort_rows`) over (valid | keys | gidx).
    Phase 2 resolves the *equal-key runs* of valid rows (suffixes sharing
    their whole v-character window, the only pairs Lemma 1 is needed for)
    by (run, Λ-rank, slot) — slot order within a run is gidx order — and
    runs only when phase 1 left such a run, as the reference's `lax.cond`
    does. It orders just the tied rows (`core.words.lemma1_order`: a
    keyed class sort and one merge launch, whatever the runs' widths); the
    other rows are alone in their run and keep their slot, so the result
    is the reference's whole-shard pass. Pad rows never trigger it: their
    order is fixed by the unique gidx key."""
    cr = 1 + nk
    ck = 1 + nk + dsize
    cg = 2 + nk + dsize

    def local_sort(rows: torch.Tensor) -> torch.Tensor:
        m = rows.shape[0]
        rows = rows[argsort_rows(rows, list(range(1 + nk)) + [cg], key_sort)]
        head = rows[:, :1 + nk]
        is_start = torch.ones(m, dtype=torch.bool, device=rows.device)
        is_start[1:] = (head[1:] != head[:-1]).any(dim=1)
        run_start, sizes = run_state(is_start)
        tied = (sizes > 1) & (rows[:, 0] == 0)
        n_tied = int(tied.sum())
        if not n_tied:
            return rows
        sl = compact(tied, n_tied)
        order = torch.arange(m, device=rows.device)
        order[sl] = lemma1_order(sl, sl - run_start[sl], sizes[sl],
                                 rows[sl, cr:ck].long(), rows[sl, ck].long(),
                                 lam_i1, lam_i2, RANK_BOUND)
        return rows[order]

    return local_sort


# --------------------------------------------------------------------------
# Algorithm 2 body
# --------------------------------------------------------------------------
def psort_shard_body(me: int, rows: torch.Tensor, *, p: int, lt_fn=None,
                     local_sort=None):
    """Rank `me`'s body (a generator, run by `LocalMesh.run` or with
    ``yield from``). Returns globally sorted, block-balanced rows
    int32[m_local, W] (pads last globally), plus this rank's local overflow
    flag (callers MUST gather it across ranks and raise — see
    `repro_torch.bsp.exchange`)."""
    if lt_fn is None:
        lt_fn = lex_lt_full
    if local_sort is None:
        local_sort = local_sort_lex
    m, W = rows.shape
    dev = rows.device

    # --- 1. local sort ---
    rows = local_sort(rows)
    nvalid = (rows[:, 0] == 0).sum()

    # --- 2. p+1 equally spaced primary samples (incl. min/max) ---
    t = torch.arange(p + 1, device=dev)
    primary = rows[t * (nvalid - 1).clamp(min=0) // p]
    primary = torch.where(nvalid > 0, primary,
                          make_pad_rows(p + 1, W, device=dev))

    # --- 3. gather all p(p+1) samples everywhere ---
    all_samples = (yield all_gather(primary)).reshape(p * (p + 1), W)
    all_samples = local_sort(all_samples)
    ns = (all_samples[:, 0] == 0).sum()

    # --- 4. p-1 secondary splitters → p buckets ---
    tt = torch.arange(1, p, device=dev)
    splitters = all_samples[tt * (ns - 1).clamp(min=0) // p]
    valid = rows[:, 0] == 0
    dest = searchsorted_rows(splitters, rows, lt_fn=lt_fn).clamp(0, p - 1)

    # --- 5. bucket exchange (2 supersteps) + local sort ---
    cap_out = 2 * m + 2 * p + 4
    got, got_valid, over1 = yield from exchange(rows, dest, valid, p=p,
                                                cap_out=cap_out)
    got = torch.where(got_valid[:, None], got,
                      make_pad_rows(cap_out, W, device=dev))
    got = local_sort(got)

    # --- 6. rebalance to exactly m rows per rank, preserving global order ---
    counts = (yield all_gather(got_valid.sum()[None])).reshape(p)
    my_off = (torch.cumsum(counts, 0) - counts)[me]
    gpos = my_off + torch.arange(cap_out, device=dev)
    dest2 = (gpos // m).clamp(0, p - 1)
    # carry gpos so the receiver can put each row in its place
    carried = torch.cat([gpos[:, None].to(torch.int32), got], dim=1)
    out, out_valid, over2 = yield from exchange(
        carried, dest2, got[:, 0] == 0, p=p, cap_out=m)
    # Rank `me` receives the valid rows with gpos in [me·m, me·m + k): the
    # gpos is the row's slot, which orders them as the reference's stable
    # argsort by gpos does; the other slots keep their pad rows.
    slot = out[:, 0].long() - me * m
    slot = torch.where(out_valid & (slot >= 0) & (slot < m), slot, m)
    res = make_pad_rows(m + 1, W, device=dev)
    res[slot] = out[:, 1:]
    return res[:m], over1 | over2


def run_psort(mesh, axis: str, rows_global: torch.Tensor, *, lt_fn=None,
              local_sort=None, check: bool = True):
    """`psort_shard_body` on every rank of a 1-D mesh.

    rows_global: int32[p*m, W], rank r taking rows [r*m, (r+1)*m). Returns
    (rows_sorted int32[p*m, W], over bool[p]) on the mesh's first device;
    raises RuntimeError when any rank's exchange overflowed (pass
    ``check=False`` to inspect the flags instead)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    p = mesh_num_devices(mesh)
    if rows_global.shape[0] % p:
        raise ValueError(f"{rows_global.shape[0]} rows do not split into "
                         f"{p} equal blocks")
    m = rows_global.shape[0] // p
    dev0 = mesh.devices[0]
    outs = mesh.run(
        lambda me, rows: psort_shard_body(me, rows, p=p, lt_fn=lt_fn,
                                          local_sort=local_sort),
        [(rows_global[r * m:(r + 1) * m].to(dev),)
         for r, dev in enumerate(mesh.devices)])
    out = torch.cat([o.to(dev0) for o, _ in outs])
    over = torch.stack([f.to(dev0) for _, f in outs])
    if check and bool(over.any()):
        raise RuntimeError(
            "psort exchange capacity overflow — the deterministic two-hop "
            "caps were exceeded (bug in the cap_out bound, not bad input)")
    return out, over
