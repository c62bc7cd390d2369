"""Deterministic ragged row exchange over dense all_to_all (two hops): the
port of `repro.bsp.exchange`.

The paper's "send each element to its bucket's processor" h-relation is
two dense `all_to_all` hops with *per-destination round-robin*
intermediate placement:

  hop 1: row r — the i-th valid row of this rank destined to rank d — is
         sent to intermediate rank q = i mod p. Per-(src,q) traffic is
         ≤ Σ_d ⌈n_{s,d}/p⌉ ≤ m/p + p rows: cap1 = ⌈m/p⌉ + p.
  hop 2: intermediate q forwards to d; per-(q,d) traffic is
         Σ_s ⌈n_{s,d}/p⌉ ≤ total_d/p + p ≤ cap_out/p + p rows.

Both caps are deterministic (adversarial-input safe), so total per-rank
communication is O(m + p²) words per exchange. Exactly 2 supersteps: the
overflow flag is computed locally (no extra collective).

Overflow contract: `exchange` returns a rank-local `overflowed` flag
covering every way a cap can be exceeded (hop-1 slots, hop-2 slots,
cap_out arrivals). The flag is a bug detector, not a runtime condition:
every call site's cap is sound by construction (psort bucket exchange
2m + 2p + 4, psort rebalance m, SM1 rank routing and SM2 un-routing
m_loc), so callers gather it and raise `RuntimeError` on any set flag.
"""
from __future__ import annotations

import torch

from ..launch.mesh import all_to_all
from .primitives import compact_valid, within_group_index


def hop_caps(m: int, p: int, cap_out: int) -> tuple[int, int]:
    cap1 = -(-m // p) + p
    cap2 = -(-cap_out // p) + p
    return cap1, cap2


def _hop(payload: torch.Tensor, to: torch.Tensor, slot: torch.Tensor,
         keep: torch.Tensor, p: int, cap: int) -> torch.Tensor:
    """[p, cap, W] send buffer: row i of `payload` at (to[i], slot[i]) where
    `keep`, every other slot -1. Rows not kept (invalid or past the cap)
    are dropped, as ``.at[].set(mode="drop")`` drops them."""
    buf = torch.full((p * cap + 1, payload.shape[1]), -1, dtype=torch.int32,
                     device=payload.device)
    flat = torch.where(keep, to.long() * cap + slot, p * cap)
    buf[flat] = payload                          # dropped rows: the last row
    return buf[:-1].view(p, cap, payload.shape[1])


def exchange(rows: torch.Tensor, dest: torch.Tensor, valid: torch.Tensor, *,
             p: int, cap_out: int):
    """Route valid rows (int32[m, W]) to their dest ranks (int[m] in
    [0, p)). A generator, run inside a rank's body: ``yield from``.

    Returns (out_rows int32[cap_out, W], out_valid bool[cap_out],
    overflowed bool 0-d): rows arrive grouped by source rank, then in
    round-robin order; callers re-sort locally. Slots past the arrivals
    hold -1. Callers MUST gather `overflowed` across ranks and raise on
    any set flag (see the module docstring).
    """
    m, W = rows.shape
    cap1, cap2 = hop_caps(m, p, cap_out)

    # ---- hop 1: per-destination round robin ----
    i_d = within_group_index(dest, valid)
    inter = torch.where(valid, i_d % p, p)               # p → dropped
    slot1 = within_group_index(inter, valid).long()
    over1 = (valid & (slot1 >= cap1)).any()
    payload1 = torch.cat([dest[:, None].to(torch.int32), rows], dim=1)
    recv1 = yield all_to_all(_hop(payload1, inter, slot1,
                                  valid & (slot1 < cap1), p, cap1))
    flat1 = recv1.reshape(p * cap1, W + 1)
    dest2 = flat1[:, 0]
    valid2 = dest2 >= 0

    # ---- hop 2: forward to true destination ----
    slot2 = within_group_index(dest2, valid2).long()
    over2 = (valid2 & (slot2 >= cap2)).any()
    recv2 = yield all_to_all(_hop(flat1, dest2, slot2,
                                  valid2 & (slot2 < cap2), p, cap2))
    flat2 = recv2.reshape(p * cap2, W + 1)
    got = flat2[:, 0] >= 0

    # compact to cap_out
    flat2, got, _ = compact_valid(flat2, got)
    over3 = got.sum() > cap_out
    return flat2[:cap_out, 1:], got[:cap_out], over1 | over2 | over3
