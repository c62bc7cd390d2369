"""Algorithm 3 — BSP parallel suffix array construction by accelerated
sampling, on a 1-D `repro_torch.launch.mesh.LocalMesh`: the port of
`repro.bsp.suffix_array`.

Round structure (per recursion level i, modulus v = v_i, cover D = D_i):

  SM1  (11 supersteps): char halo → sample super-character windows →
       Algorithm-2 psort (key mode) → global dense rank (+ all-distinct
       flag) → route ranks to the block-major X' layout.
  rec  : recurse on X' with v' = min(⌈v^{5/4}⌉, ⌈v²/|D|⌉−1, |X'|); base case
       (|X'| ≤ threshold ≈ n/p) gathers X' and solves it with the
       single-device DC-v (`suffix_array_torch`) on the mesh's first
       device (the paper's "send to processor 0").
  SM2  (9 supersteps): route sample ranks back to position owners → rank/char
       halos → build self-contained Lemma-1 payloads → Algorithm-2 psort
       (the fused Steps 2–4) → SA.

The rank-local sorts inside both psorts follow `sort_impl` (see
`repro_torch.bsp.psort`): "radix" packs the SM1 windows and the SM2
payload characters into 30-bit key lanes and key-sorts them with
`radix_argsort` (the hand-written kernels on the card); "torch" is the
same two-phase sort on unpacked columns with `torch.sort`; "bitonic" is
the legacy comparator network in SM2.

All shapes are functions of (n, p, schedule): the index domain is padded
to n_pv = p·v·⌈n/(p·v)⌉ so every rank holds n_loc = n_pv/p characters (a
multiple of v) and exactly m_loc = |D|·n_loc/v sample windows.
Sentinel-pad suffixes sort first and are trimmed at the end.

Superstep accounting: the counts logged by `BSPCounters` (SM1 = 11, SM2 = 9
per round — `_round_cost`) match the collectives the bodies yield, barrier
for barrier (`LocalMesh.rendezvous` counts them): SM1 = halo ppermute + 6
psort collectives + boundary ppermute + rank-offset all_gather + 2 routing
all_to_alls; SM2 = 2 un-routing all_to_alls + halo ppermute + 6 psort
collectives. Diagnostic flags (overflow, all-distinct) are computed
rank-locally and returned by the bodies, so they add no barriers.
`estimate_costs` replays the same schedule analytically for any (n, p).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.dcv_torch import cover_constants, suffix_array_torch
from ..core.difference_cover import cover_tables
from ..core.seq_ref import accelerated_next_v
from ..launch.mesh import all_gather, mesh_num_devices, ppermute
from ..trace import span
from .counters import BSPCounters, NULL_COUNTERS
from .exchange import exchange
from .psort import (key_sort_of, local_sort_lex, make_local_sort_bitonic,
                    make_local_sort_keyed, make_payload_lt, pack_key_columns,
                    packed_width, psort_shard_body, quantize_sigma,
                    resolve_bsp_sort_impl)

I32 = torch.int32


# --------------------------------------------------------------------------
# round geometry
# --------------------------------------------------------------------------
def round_geometry(n: int, p: int, v: int):
    n_pv = p * v * math.ceil(n / (p * v))
    n_loc = n_pv // p
    tabs = cover_tables(v)
    dsize = len(tabs.D)
    m_loc = dsize * n_loc // v          # samples per rank == X' elems/rank
    m_tot = m_loc * p
    return n_pv, n_loc, m_loc, m_tot, tabs


# --------------------------------------------------------------------------
# SM1: sample sort + X' construction
# --------------------------------------------------------------------------
def pack_window_columns(win: torch.Tensor, sigma: int):
    """Key packing for SM1 windows: characters are shifted +1 so the -1
    sentinel packs as 0, then packed into 30-bit int32 lanes by
    `pack_key_columns` (order-preserving, injective)."""
    return pack_key_columns(win, -1, sigma)


def _scatter_drop(size: int, index: torch.Tensor, values: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """int32[size] filled with `fill`, `values` written at `index`; indices
    outside [0, size) are dropped, as ``.at[].set(mode="drop")`` drops
    them."""
    out = torch.full((size + 1,), fill, dtype=I32, device=values.device)
    out[torch.where((index >= 0) & (index < size), index, size)] = values
    return out[:size]


def _sm1_body(me: int, xloc, *, p, v, n_loc, m_loc, sigma=None,
              key_sort="radix"):
    dev = xloc.device
    D = cover_constants(v, dev)[0]

    # --- char halo: first v chars of next rank (last rank: sentinels) ---
    halo = yield ppermute(xloc[:v], [(s, s - 1) for s in range(1, p)])
    if me == p - 1:
        halo = torch.full((v,), -1, dtype=I32, device=dev)
    xp = torch.cat([xloc, halo])                            # [n_loc + v]

    # --- sample windows (block-local positions ≡ k (mod v), k ∈ D) ---
    off = (D[:, None] + torch.arange(n_loc // v, device=dev)[None, :] * v
           ).reshape(-1)                                    # [m_loc] local pos
    gpos = me * n_loc + off
    win = xp[off[:, None] + torch.arange(v, device=dev)[None, :]]
    if sigma is not None:
        win = pack_window_columns(win, sigma)
    w = win.shape[1]                       # packed key width ≤ v
    rows = torch.cat([torch.zeros((m_loc, 1), dtype=I32, device=dev),
                      win.to(I32), gpos[:, None].to(I32)], dim=1)

    # --- Algorithm 2 (key mode) ---
    rows, over = yield from psort_shard_body(
        me, rows, p=p,
        local_sort=functools.partial(local_sort_lex, key_sort=key_sort))

    # --- global dense rank of windows + distinct flag ---
    keys = rows[:, 1:1 + w]
    prev_last = yield ppermute(keys[-1:], [(s, s + 1) for s in range(p - 1)])
    b = torch.ones(m_loc, dtype=torch.int64, device=dev)
    if me > 0:
        b[0] = (keys[0] != prev_last[0]).any()
    b[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    sums = (yield all_gather(b.sum()[None])).reshape(p)
    rank = (torch.cumsum(sums, 0) - sums)[me] + torch.cumsum(b, 0) - 1
    # rank-local "every window here started a run"; the controller ANDs
    # the per-rank flags — no barrier needed.
    distinct = b.min() == 1

    # --- route (j, rank) to X' owners; j = block-major sample index ---
    d_idx = np.full(v, -1, np.int64)
    for a_i, dd in enumerate(cover_tables(v).D):
        d_idx[dd] = a_i
    g = rows[:, 1 + w].long()                               # gpos
    j = torch.as_tensor(d_idx, device=dev)[g % v] * ((n_loc // v) * p) \
        + g // v
    rows2 = torch.cat([torch.zeros((m_loc, 1), dtype=I32, device=dev),
                       rank[:, None].to(I32), j[:, None].to(I32)], dim=1)
    got, got_valid, over2 = yield from exchange(
        rows2, (j // m_loc).clamp(0, p - 1),
        torch.ones(m_loc, dtype=torch.bool, device=dev), p=p, cap_out=m_loc)
    xprime = _scatter_drop(
        m_loc, torch.where(got_valid, got[:, 2].long() % m_loc, m_loc),
        got[:, 1], 0)
    return xprime, distinct, over | over2


# --------------------------------------------------------------------------
# SM2: rank scatter + fused Lemma-1 payload sort
# --------------------------------------------------------------------------
def _sm2_body(me: int, xloc, sa_rank_loc, *, p, v, n_loc, m_loc,
              impl="bitonic", sigma=None, key_sort="radix"):
    dev = xloc.device
    D, _, shifts, lam_i1, lam_i2 = cover_constants(v, dev)
    dsize = len(D)
    per_block = (n_loc // v) * p                            # block length in X'

    # --- route sample ranks back to position owners ---
    jloc = me * m_loc + torch.arange(m_loc, device=dev)
    blk = jloc // per_block                                  # index into D
    pos = D[blk.clamp(0, dsize - 1)] + (jloc % per_block) * v
    rows = torch.cat([torch.zeros((m_loc, 1), dtype=I32, device=dev),
                      sa_rank_loc[:, None].to(I32), pos[:, None].to(I32)],
                     dim=1)
    got, got_valid, over = yield from exchange(
        rows, (pos // n_loc).clamp(0, p - 1),
        torch.ones(m_loc, dtype=torch.bool, device=dev), p=p, cap_out=m_loc)
    rank_loc = _scatter_drop(
        n_loc + v, torch.where(got_valid, got[:, 2].long() % n_loc,
                               n_loc + v), got[:, 1], -1)

    # --- halos: rank (v) and chars (v) from next rank ---
    fwd = torch.cat([rank_loc[:v], xloc[:v]])
    halo = yield ppermute(fwd, [(s, s - 1) for s in range(1, p)])
    if me == p - 1:
        halo = torch.full((2 * v,), -1, dtype=I32, device=dev)
    rank_loc[n_loc:] = halo[:v]
    xp = torch.cat([xloc, halo[v:]])                         # [n_loc + v]

    # --- Lemma-1 payloads for ALL local suffixes ---
    offs = torch.arange(n_loc, device=dev)
    gidx = me * n_loc + offs
    chars = xp[offs[:, None] + torch.arange(v, device=dev)[None, :]]
    klass = gidx % v
    look = (offs[:, None] + shifts[klass]).clamp(0, n_loc + v - 1)
    rvals = rank_loc[look]

    if impl == "bitonic":
        # legacy: the Lemma-1 comparator at every compare-exchange of the
        # local bitonic network, raw characters as the head.
        keys = chars
        lt = make_payload_lt(v, v, dsize, lam_i1, lam_i2)
        local_sort = make_local_sort_bitonic(lt)
    else:
        # keyed: pack ("radix") or keep raw ("torch") the character head,
        # key-sort it, and resolve equal-window runs by Lemma 1.
        keys = pack_key_columns(chars, -1, sigma) if sigma is not None \
            else chars
        # The pad suffixes share one all-sentinel window, and the ranks of
        # pad positions follow no suffix order that Lemma 1 can read: a
        # lookup that lands on a pad reads -1, so the pads' ties fall to
        # gidx (they are trimmed after the sort). Tied real suffixes look up
        # real positions only.
        rvals = torch.where(xp[look] < 0, -1, rvals)
        lt = make_payload_lt(keys.shape[1], v, dsize, lam_i1, lam_i2)
        local_sort = make_local_sort_keyed(keys.shape[1], v, dsize, lam_i1,
                                           lam_i2, key_sort)
    nk = keys.shape[1]
    payload = torch.cat([torch.zeros((n_loc, 1), dtype=I32, device=dev),
                         keys.to(I32), rvals.to(I32), klass[:, None].to(I32),
                         gidx[:, None].to(I32)], dim=1)
    out, over2 = yield from psort_shard_body(me, payload, p=p, lt_fn=lt,
                                             local_sort=local_sort)
    return out[:, 2 + nk + dsize], over | over2             # gidx column


# --------------------------------------------------------------------------
# stage wrappers: one mesh run each
# --------------------------------------------------------------------------
def _flags(mesh, flags) -> torch.Tensor:
    return torch.stack([f.to(mesh.devices[0]) for f in flags])


def _sm1(mesh, xg, *, p, v, n_loc, m_loc, sigma=None, key_sort="radix"):
    """SM1 on every rank of `mesh`: xg holds each rank's n_loc characters.
    Returns (X' per rank, distinct bool[p], overflow bool[p])."""
    out = mesh.run(functools.partial(_sm1_body, p=p, v=v, n_loc=n_loc,
                                     m_loc=m_loc, sigma=sigma,
                                     key_sort=key_sort),
                   [(x,) for x in xg])
    return ([o[0] for o in out], _flags(mesh, [o[1] for o in out]),
            _flags(mesh, [o[2] for o in out]))


def _sm2(mesh, xg, sa_rank, *, p, v, n_loc, m_loc, impl="bitonic",
         sigma=None, key_sort="radix"):
    """SM2 on every rank of `mesh`. Returns (each rank's n_loc SA entries,
    overflow bool[p])."""
    out = mesh.run(functools.partial(_sm2_body, p=p, v=v, n_loc=n_loc,
                                     m_loc=m_loc, impl=impl, sigma=sigma,
                                     key_sort=key_sort),
                   list(zip(xg, sa_rank)))
    return [o[0] for o in out], _flags(mesh, [o[1] for o in out])


# --------------------------------------------------------------------------
# the recursion
# --------------------------------------------------------------------------
def _round_cost(label, n_loc, m_loc, p, v, dsize, W, counters):
    """Analytic per-superstep BSP costs for one SM stage."""
    lb = int(math.ceil(math.log2(max(m_loc * 4, 2))))
    psort = [
        ("psort/sample_gather", p * (p + 1) * W, m_loc * W * lb),
        ("psort/a2a_hop1", m_loc * W, m_loc * W),
        ("psort/a2a_hop2", 2 * m_loc * W, m_loc * W),
        ("psort/count_gather", p, 2 * m_loc * W * lb),
        ("psort/rebal_hop1", 2 * m_loc * W, m_loc * W),
        ("psort/rebal_hop2", m_loc * W, m_loc * W * lb),
    ]
    if label == "SM1":
        steps = ([("halo", v, n_loc)] + psort
                 + [("rank/boundary", W, m_loc * W), ("rank/scan", p, m_loc),
                    ("route/a2a_hop1", 3 * m_loc, m_loc),
                    ("route/a2a_hop2", 3 * m_loc, m_loc)])
    else:
        steps = ([("unroute/a2a_hop1", 3 * m_loc, m_loc),
                  ("unroute/a2a_hop2", 3 * m_loc, m_loc),
                  ("halo", 2 * v, n_loc)] + psort)
    for name, h, w in steps:
        counters.superstep(f"{label}/{name}", h=h, w=w)


def _check_overflow(over, stage: str) -> None:
    """Turn a gathered per-rank overflow flag into a hard error."""
    if bool(torch.as_tensor(over).any()):
        raise RuntimeError(
            f"BSP exchange capacity overflow in {stage}: the deterministic "
            f"two-hop caps were exceeded — a bug in the caller's cap_out "
            f"bound (see repro_torch.bsp.exchange), never an input-data "
            f"error")


def _sm_widths(v: int, sigma: int, impl: str, pack_keys: bool):
    """(SM1 sigma-or-None, SM1 key lanes, SM2 sigma-or-None, SM2 key lanes).

    "radix" packs both stages; "torch" packs neither; "bitonic" keeps the
    legacy behaviour (SM1 packing per `pack_keys`, SM2 raw characters)."""
    sm1_sigma = sigma if (impl == "radix"
                          or (impl == "bitonic" and pack_keys)) else None
    w1 = packed_width(v, -1, sigma) if sm1_sigma is not None else v
    sm2_sigma = sigma if impl == "radix" else None
    nk2 = packed_width(v, -1, sigma) if sm2_sigma is not None else v
    return sm1_sigma, w1, sm2_sigma, nk2


def suffix_array_bsp(
    x,
    mesh,
    axis: str = "bsp",
    v: int = 3,
    schedule=accelerated_next_v,
    base_threshold: int | None = None,
    counters: BSPCounters = NULL_COUNTERS,
    pack_keys: bool = True,
    sort_impl: str = "auto",
    _n0: int | None = None,
) -> torch.Tensor:
    """Distributed suffix array of x (ints ≥ 0, < 2³¹) over a 1-D mesh.
    Returns int32[n] on the mesh's first device.

    `sort_impl` selects the rank-local sort family inside both Algorithm-2
    psorts ("auto" → packed-key "radix"; see `repro_torch.bsp.psort`)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    dev0 = mesh.devices[0]
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(
        device=dev0, dtype=torch.int64).reshape(-1)
    n = len(x)
    p = mesh_num_devices(mesh)
    impl = resolve_bsp_sort_impl(sort_impl, pack_keys)
    key_sort = key_sort_of(impl)
    if p == 1:
        # degenerate mesh: Algorithm 2's splitter machinery needs p ≥ 2;
        # a 1-processor BSP run IS the single-device algorithm.
        counters.superstep("base/gather", h=n, w=n * 4)
        return suffix_array_torch(x, v=max(v, 3), schedule=schedule,
                                  base_threshold=base_threshold or 256,
                                  device=dev0)
    n0 = _n0 or n
    if base_threshold is None:
        base_threshold = max(1024, n0 // p)

    def rec(x: torch.Tensor, v: int) -> torch.Tensor:
        n = len(x)
        if n <= max(base_threshold, 2 * p * v, 8):
            # paper: |X'| ≤ n/p → ship to one processor, solve sequentially.
            counters.superstep("base/gather", h=n, w=n * 4)
            with span("repro_torch.bsp.base"):
                return suffix_array_torch(x, v=3, device=dev0).long()
        v = int(min(max(v, 3), n))
        n_pv, n_loc, m_loc, m_tot, tabs = round_geometry(n, p, v)
        dsize = len(tabs.D)
        xp = torch.full((n_pv,), -1, dtype=I32, device=dev0)
        xp[:n] = x
        xg = [xp[r * n_loc:(r + 1) * n_loc].to(dev)
              for r, dev in enumerate(mesh.devices)]
        geom = {"p": p, "v": v, "n_loc": n_loc, "m_loc": m_loc,
                "key_sort": key_sort}

        sigma = quantize_sigma(int(x.max()) + 1)
        sm1_sigma, w1, sm2_sigma, nk2 = _sm_widths(v, sigma, impl, pack_keys)
        with span("repro_torch.bsp.sm1"):
            xprime, distinct, over = _sm1(mesh, xg, sigma=sm1_sigma, **geom)
            _round_cost("SM1", n_loc, m_loc, p, v, dsize, w1 + 2, counters)
            _check_overflow(over, "SM1")

        # saca-lint: allow[SCHED001] host-uniform by construction: `distinct`
        # holds every rank's flag and the one controller ANDs it, so every
        # rank follows the same branch and the recursion depth is global.
        if bool(distinct.all()):
            sa_rank = xprime                                  # ranks are final
        else:
            v_next = schedule(v, dsize, m_tot)
            sa_sub = rec(torch.cat([t.to(dev0) for t in xprime]).long(),
                         v_next)
            inv = torch.empty(m_tot, dtype=I32, device=dev0)
            inv[sa_sub] = torch.arange(m_tot, dtype=I32, device=dev0)
            sa_rank = [inv[r * m_loc:(r + 1) * m_loc].to(dev)
                       for r, dev in enumerate(mesh.devices)]

        with span("repro_torch.bsp.sm2"):
            sa, over = _sm2(mesh, xg, sa_rank, impl=impl, sigma=sm2_sigma,
                            **geom)
            _round_cost("SM2", n_loc, m_loc, p, v, dsize, 3 + nk2 + dsize,
                        counters)
            _check_overflow(over, "SM2")
        sa = torch.cat([s.to(dev0) for s in sa]).long()
        return sa[sa < n]                                     # trim pads

    # top-level all-distinct shortcut (recursion base of Algorithm 3)
    if n <= max(base_threshold, 2 * p * 3, 8):
        counters.superstep("base/gather", h=n, w=n * 4)
        return suffix_array_torch(x, v=3, device=dev0)
    return rec(x, v).to(I32)


# --------------------------------------------------------------------------
# analytic cost model ("model only" mode)
# --------------------------------------------------------------------------
def estimate_costs(
    n: int,
    p: int,
    *,
    v: int = 3,
    schedule=accelerated_next_v,
    base_threshold: int | None = None,
    sort_impl: str = "auto",
    pack_keys: bool = True,
    sigma: int = 256,
) -> BSPCounters:
    """Replay `suffix_array_bsp`'s superstep schedule without executing it.

    Returns a `BSPCounters` holding the supersteps/communication/work a run
    would log on an input that never triggers the all-distinct recursion
    short-circuit (the worst case — e.g. an all-equal text, for which the
    replay is exact: same labels, same S). `sigma` is the level-0 alphabet
    bound; deeper levels use the dense-rank bound m_tot, so H/W are
    estimates while S and the label sequence are structural."""
    ct = BSPCounters()
    impl = resolve_bsp_sort_impl(sort_impl, pack_keys)
    n = int(n)
    if p == 1:
        ct.superstep("base/gather", h=n, w=n * 4)
        return ct
    if base_threshold is None:
        base_threshold = max(1024, n // p)
    if n <= max(base_threshold, 2 * p * 3, 8):
        ct.superstep("base/gather", h=n, w=n * 4)
        return ct

    def rec(nn: int, vv: int, sig: int) -> None:
        if nn <= max(base_threshold, 2 * p * vv, 8):
            ct.superstep("base/gather", h=nn, w=nn * 4)
            return
        vv = int(min(max(vv, 3), nn))
        n_pv, n_loc, m_loc, m_tot, tabs = round_geometry(nn, p, vv)
        dsize = len(tabs.D)
        _, w1, _, nk2 = _sm_widths(vv, quantize_sigma(sig), impl, pack_keys)
        _round_cost("SM1", n_loc, m_loc, p, vv, dsize, w1 + 2, ct)
        rec(m_tot, schedule(vv, dsize, m_tot), m_tot)
        _round_cost("SM2", n_loc, m_loc, p, vv, dsize, 3 + nk2 + dsize, ct)

    rec(n, max(v, 3), sigma)
    return ct
