"""Lemma-1 tie resolution of the port (`core.words.lemma1_order`): a
keyed sort of each tie group's classes, then one `lemma1_merge` launch.

Builds are held to the naive oracle (`repro_torch.core.oracle`); the merge
to a comparator sort of each group written out in Python; the rank-local
sort of Algorithm 3 (`bsp.psort.make_local_sort_keyed`) to the port's own
comparator-bitonic network and to the suffix array. The `gpu` case holds
the CUDA kernel to its plain version on the card at a level-0 payload; it
skips without a card. This file imports no JAX, so it runs where only
PyTorch is installed.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.bsp import psort
from repro_torch.bsp.suffix_array import suffix_array_bsp
from repro_torch.core import dcv_torch
from repro_torch.core.words import lemma1_order
from repro_torch.core.difference_cover import cover_tables
from repro_torch.core.oracle import suffix_array_doubling
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_sa_mesh

SEED = 20261018


def _tables(v: int, device="cpu"):
    tabs = cover_tables(v)
    return (torch.as_tensor(tabs.shifts.astype(np.int64), device=device),
            torch.as_tensor(tabs.lam_idx1.astype(np.int64), device=device),
            torch.as_tensor(tabs.lam_idx2.astype(np.int64), device=device))


def _repeated_phrases(seed: int, n: int = 1500, copies: int = 30):
    """A text over a wide alphabet with one 24-token phrase pasted `copies`
    times: every window inside the phrase is one tie group of `copies`
    rows, wider than any lane of the old lane-parallel route."""
    rng = np.random.default_rng([SEED, seed])
    x = rng.integers(0, 5000, n)
    phrase = rng.integers(0, 5000, 24)
    for at in rng.choice(n // 30 - 1, copies, replace=False) * 30:
        x[at:at + 24] = phrase
    return x


def _payload(seed: int, n_rows: int, v: int, device="cpu"):
    """A tie payload whose ranks follow a total order: groups of widths 1
    to 40 (most of them 2), positions ascending, and in each group the
    ranks of one monotone rank function rank(q) = q or top - q, or one
    constant (every comparison ties, so p decides). Returns (p, lane,
    width, rvals, klass, rank_bound)."""
    rng = np.random.default_rng([SEED, seed, v])
    widths = rng.choice([2, 2, 2, 3, 5, 17, 40], n_rows)
    last = int(np.searchsorted(np.cumsum(widths), n_rows))
    widths = widths[:last + 1]
    widths[-1] -= widths.sum() - n_rows
    group = np.repeat(np.arange(len(widths)), widths)
    lane = np.arange(n_rows) - (np.cumsum(widths) - widths)[group]
    width = widths[group]
    p = np.cumsum(rng.integers(1, 4, n_rows))
    top = int(p[-1]) + v
    klass = p % v
    look = p[:, None] + cover_tables(v).shifts.astype(np.int64)[klass]
    kind = rng.integers(0, 3, len(widths))[group][:, None]
    const = rng.integers(-1, top, len(widths))[group][:, None]
    rvals = np.where(kind == 0, look, np.where(kind == 1, top - look, const))
    t = functools.partial(torch.as_tensor, device=device)
    return (t(p), t(lane), t(width), t(rvals), t(klass), top + 1)


def _lemma1_lt(j, i, p, rvals, klass, lam1, lam2) -> bool:
    b, a = int(klass[j]), int(klass[i])
    c, t = int(rvals[j, lam1[b, a]]), int(rvals[i, lam2[b, a]])
    return c < t or (c == t and int(p[j]) < int(p[i]))


def _comparator_order(p, lane, rvals, klass, lam1, lam2):
    """Each group's rows sorted with the Lemma-1 comparator, one
    comparison at a time: the positions in order."""
    out, n = [], len(p)
    starts = [i for i in range(n) if int(lane[i]) == 0] + [n]
    cmp = functools.cmp_to_key(
        lambda i, j: -1 if _lemma1_lt(i, j, p, rvals, klass, lam1, lam2)
        else 1 if _lemma1_lt(j, i, p, rvals, klass, lam1, lam2) else 0)
    for s, e in zip(starts, starts[1:]):
        out += [int(p[i]) for i in sorted(range(s, e), key=cmp)]
    return out


def _class_sorted(p, lane, rvals, klass, lam1):
    """The merge's input: rows sorted by (group, class, key, p) with stable
    torch sorts."""
    key = rvals.gather(1, lam1[klass, klass][:, None])[:, 0]
    start = torch.arange(len(p)) - lane
    perm = torch.arange(len(p))
    for col in (key, klass, start):
        perm = perm[torch.sort(col[perm], stable=True).indices]
    return perm


# ------------------------------------------------------------ full builds
@pytest.mark.parametrize("impl", ["torch", "kernel", "radix"])
@pytest.mark.parametrize("seed", range(2))
def test_builds_with_wide_tie_groups_match_the_oracle(monkeypatch, impl,
                                                      seed):
    widest = []
    order = dcv_torch.lemma1_order

    def record(p, lane, width, *args):
        widest.append(int(width.max()))
        return order(p, lane, width, *args)

    monkeypatch.setattr(dcv_torch, "lemma1_order", record)
    x = _repeated_phrases(seed)
    got = dcv_torch.suffix_array_torch(x, sort_impl=impl, device="cpu")
    np.testing.assert_array_equal(got.numpy(), suffix_array_doubling(x))
    assert max(widest) > 16, widest


@pytest.mark.parametrize("v", [3, 5, 8])
def test_all_equal_text_is_one_tie_group(v):
    x = np.zeros(400, np.int64)
    got = dcv_torch.suffix_array_torch(x, v=v, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.arange(400)[::-1])


# -------------------------------------------------------------- the merge
@pytest.mark.parametrize("v", [3, 4, 5, 8, 14, 27])
def test_lemma1_order_equals_the_comparator_sort(v):
    p, lane, width, rvals, klass, bound = _payload(v, 1500, v)
    _, lam1, lam2 = _tables(v)
    want = _comparator_order(p, lane, rvals, klass, lam1, lam2)
    got = lemma1_order(p, lane, width, rvals, klass, lam1, lam2, bound)
    assert got.tolist() == want
    perm = _class_sorted(p, lane, rvals, klass, lam1)
    merged = ref.lemma1_merge_ref(p[perm], klass[perm], rvals[perm], lane,
                                  width, lam1, lam2)
    assert merged.tolist() == want


def test_ties_of_the_comparator_fall_to_p():
    """Every rank of the payload equal: each comparison ties, so each
    group keeps its rows in ascending p, whatever the classes."""
    v = 5
    p, lane, width, rvals, klass, bound = _payload(1, 400, v)
    rvals = torch.full_like(rvals, 7)
    klass = torch.as_tensor(np.random.default_rng(SEED).integers(0, v, 400))
    _, lam1, lam2 = _tables(v)
    got = lemma1_order(p, lane, width, rvals, klass, lam1, lam2, bound)
    assert got.tolist() == p.tolist()
    assert got.tolist() == _comparator_order(p, lane, rvals, klass, lam1,
                                             lam2)


@pytest.mark.parametrize("v", [3, 8])
def test_each_group_is_a_permutation_of_its_rows(v):
    p, lane, width, rvals, klass, bound = _payload(2, 2000, v)
    _, lam1, lam2 = _tables(v)
    got = lemma1_order(p, lane, width, rvals, klass, lam1, lam2, bound)
    start = (torch.arange(len(p)) - lane).tolist()
    for s in sorted(set(start)):
        w = int(width[s])
        assert sorted(got[s:s + w].tolist()) == p[s:s + w].tolist()
    assert ops.LAUNCHES["lemma1_merge"] == 0          # the CPU launches none


# -------------------------------------------- Algorithm 3's local sort
@pytest.mark.parametrize("packed", [False, True])
def test_keyed_local_sort_orders_a_wide_run(packed):
    v, n = 3, 600
    x = _repeated_phrases(2, n, copies=19) % 50
    sa = suffix_array_doubling(x)
    shifts, lam1, lam2 = _tables(v)
    rank = np.full(n + v, -1, np.int64)
    sample = cover_tables(v).in_D[np.arange(n) % v]
    inv = np.empty(n, np.int64)
    inv[sa] = np.arange(n)
    rank[:n][sample] = inv[sample]
    pos = np.arange(n)
    chars = np.concatenate([x, np.full(v, -1)])[pos[:, None]
                                                 + np.arange(v)[None, :]]
    keys = torch.as_tensor(chars.astype(np.int32))
    if packed:
        keys = psort.pack_key_columns(keys, -1, psort.quantize_sigma(50))
    rvals = rank[pos[:, None] + shifts.numpy()[pos % v]]
    rows = np.concatenate([np.zeros((n, 1)), keys.numpy(), rvals,
                           (pos % v)[:, None], pos[:, None]], axis=1)
    rows = torch.as_tensor(rows[np.random.default_rng(SEED).permutation(n)]
                           .astype(np.int32))
    rows = torch.cat([rows, psort.make_pad_rows(5, rows.shape[1])])
    nk, dsize = keys.shape[1], shifts.shape[1]
    _, counts = torch.unique(rows[:n, :1 + nk], dim=0, return_counts=True)
    assert int(counts.max()) > 16
    got = psort.make_local_sort_keyed(nk, v, dsize, lam1, lam2)(rows)
    lt = psort.make_payload_lt(nk, v, dsize, lam1, lam2)
    # the valid rows; the network pads its input with rows of its own
    torch.testing.assert_close(got[:n],
                               psort.make_local_sort_bitonic(lt)(rows)[:n],
                               rtol=0, atol=0)
    np.testing.assert_array_equal(got[:n, -1].numpy(), sa)


@pytest.mark.parametrize("impl", ["radix", "torch"])
def test_keyed_bsp_build_with_wide_runs_matches_the_oracle(impl):
    x = _repeated_phrases(3, 1200, copies=24) % 40
    got = suffix_array_bsp(x, make_sa_mesh(4, device="cpu"),
                           base_threshold=64, sort_impl=impl)
    np.testing.assert_array_equal(got.numpy(), suffix_array_doubling(x))


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("v,n_rows", [(3, 14_000_000), (5, 1_000_000),
                                      (81, 200_000)])
def test_lemma1_merge_kernel_matches_plain(cuda, v, n_rows):
    """Level 0 of the infini-gram cell ties ~14 M rows at v = 3; v = 81
    reads its column tables from device memory."""
    p, lane, width, rvals, klass, bound = _payload(4, n_rows, v, cuda)
    _, lam1, lam2 = _tables(v, cuda)
    key = rvals.gather(1, lam1[klass, klass][:, None])[:, 0]
    start = torch.arange(n_rows, device=cuda) - lane
    perm = torch.arange(n_rows, device=cuda)
    for col in (key, klass, start):
        perm = perm[torch.sort(col[perm], stable=True).indices]
    args = (p[perm], klass[perm], rvals[perm].contiguous(), lane, width,
            lam1, lam2)
    before = ops.LAUNCHES["lemma1_merge"]
    got = ops.lemma1_merge(*args)
    assert ops.LAUNCHES["lemma1_merge"] == before + 1
    torch.testing.assert_close(got, ref.lemma1_merge_ref(*args), rtol=0,
                               atol=0)
    order = lemma1_order(p, lane, width, rvals, klass, lam1, lam2, bound)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lemma1_merge"] == before + 2
    torch.testing.assert_close(order, got, rtol=0, atol=0)
