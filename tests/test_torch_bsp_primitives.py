"""The port's BSP building blocks held against the JAX package's, in one
process and without a mesh: the rank-local primitives
(`repro_torch.bsp.primitives`), the comparator helpers of
`repro_torch.core.bitonic`, key packing and pad rows, the Lemma-1 payload
order and the rank-local sorts of `repro_torch.bsp.psort` (on payload
rows of real texts, whose equal-window runs need Lemma 1), the analytic
cost model `estimate_costs`, and the legacy single-device
``sort_impl="bitonic"`` build.

Inputs are made with numpy from a seed and handed to both packages; every
output is an integer and must be equal element for element (no
tolerance). JAX stays on the CPU (tests/conftest.py).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bsp import primitives as jprim
from repro.bsp import psort as jpsort
from repro.bsp import suffix_array as jsa
from repro.core import bitonic as jbitonic
from repro.core import dcv_jax
from repro.core.difference_cover import cover_tables
from repro.core.oracle import suffix_array_doubling
from repro.core.seq_ref import fixed_next_v
from repro_torch.api import SAOptions, build_suffix_array
from repro_torch.bsp import primitives, psort
from repro_torch.bsp import suffix_array as tsa
from repro_torch.core import bitonic
from repro_torch.core.dcv_torch import suffix_array_torch

REPO = Path(__file__).resolve().parent.parent
SEED = 20261017
#: the reference's sort_impl names where the port's differ.
REF_IMPL = {"torch": "lax"}


def _load_families():
    """`FAMILIES` of tests/api/test_fuzz_differential.py, the seeded corpus
    generators of the cross-backend fuzz suite."""
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _load_families()


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("seed", range(3))
def test_row_primitives_match_jax(seed):
    rng = np.random.default_rng([SEED, seed])
    m, W, p = 75, seed + 1, 5
    rows = rng.integers(-3, 4, (m, W)).astype(np.int32)
    other = rng.integers(-3, 4, (m, W)).astype(np.int32)
    valid = rng.random(m) < 0.7
    dest = rng.integers(0, p, m).astype(np.int32)

    got = primitives.compact_valid(_t(rows), _t(valid))
    want = jprim.compact_valid(jnp.asarray(rows), jnp.asarray(valid))
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(primitives.within_group_index(_t(dest), _t(valid)),
        jprim.within_group_index(jnp.asarray(dest), jnp.asarray(valid)))
    _eq(primitives.counts_per_bucket(_t(dest), _t(valid), p),
        jprim.counts_per_bucket(jnp.asarray(dest), jnp.asarray(valid), p))
    _eq(primitives.lex_lt_rows(_t(rows), _t(other)),
        jprim.lex_lt_rows(jnp.asarray(rows), jnp.asarray(other)))
    lt, eq = bitonic.lex_lt_int(_t(rows), _t(other))
    jlt, jeq = jbitonic.lex_lt_int(jnp.asarray(rows), jnp.asarray(other))
    _eq(lt, jlt)
    _eq(eq, jeq)
    for num_keys in range(1, W + 1):
        got = primitives.local_sort_rows(_t(rows), _t(valid), num_keys)
        want = jprim.local_sort_rows(jnp.asarray(rows), jnp.asarray(valid),
                                     num_keys)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        _eq(bitonic.sort_rows_with_index(_t(rows), num_keys),
            jbitonic.sort_rows_with_index(jnp.asarray(rows), num_keys))

    q = int(rng.integers(1, 12))
    spl = rows[np.lexsort(rows.T[::-1])][np.sort(rng.integers(0, m, q))]
    _eq(primitives.searchsorted_rows(_t(spl), _t(other)),
        jprim.searchsorted_rows(jnp.asarray(spl), jnp.asarray(other)))


def test_hop_caps_match_jax():
    from repro.bsp.exchange import hop_caps as jcaps
    from repro_torch.bsp.exchange import hop_caps
    for m, p, cap in [(1, 2, 4), (32, 8, 256), (1222, 8, 2452), (5, 3, 1)]:
        assert hop_caps(m, p, cap) == jcaps(m, p, cap)


# ------------------------------------------------------------ key packing
@pytest.mark.parametrize("lo,hi,k", [(-1, 1, 3), (-1, 30, 3), (-1, 510, 5),
                                     (0, 3, 7), (-1, 2 ** 15, 2),
                                     (-1, 2 ** 20, 4), (3, 700, 9)])
def test_pack_key_columns_match_jax(lo, hi, k):
    rng = np.random.default_rng([SEED, hi, k])
    cols = rng.integers(lo, hi + 1, (57, k)).astype(np.int32)
    got = psort.pack_key_columns(_t(cols), lo, hi)
    _eq(got, jpsort.pack_key_columns(jnp.asarray(cols), lo, hi))
    assert got.shape[1] == psort.packed_width(k, lo, hi) \
        == jpsort.packed_width(k, lo, hi)
    _eq(tsa.pack_window_columns(_t(cols), hi),
        jsa.pack_window_columns(jnp.asarray(cols), hi))


def test_quantize_sigma_and_pad_rows_match_jax():
    for sigma in [0, 1, 2, 3, 29, 30, 255, 256, 510, 511, 10 ** 6]:
        assert psort.quantize_sigma(sigma) == jpsort.quantize_sigma(sigma)
    for k, W in [(1, 3), (9, 6), (40, 12)]:
        _eq(psort.make_pad_rows(k, W), jpsort.make_pad_rows(k, W))
    _eq(psort.make_pad_rows(5, 4, tag_base=7),
        jpsort.make_pad_rows(5, 4, tag_base=7))


def test_resolve_bsp_sort_impl():
    assert psort.resolve_bsp_sort_impl("auto") == "radix"
    assert psort.resolve_bsp_sort_impl("auto", pack_keys=False) == "torch"
    for impl in ("radix", "torch", "bitonic"):
        assert psort.resolve_bsp_sort_impl(impl) == impl
        assert jpsort.resolve_bsp_sort_impl(REF_IMPL.get(impl, impl)) \
            == REF_IMPL.get(impl, impl)
    for bad in ("kernel", "lax", "pallas", "nope"):
        with pytest.raises(ValueError, match="bsp backend"):
            psort.resolve_bsp_sort_impl(bad)


# ------------------------------------------------- Lemma-1 payload sorts
def _payload(family: str, n: int, v: int, packed: bool):
    """SM2's payload rows [valid | keys | ranks | klass | gidx] for every
    position of a seeded text (n a multiple of v, -1 past its end), with
    the sample ranks of its true suffix order, shuffled, then 5 pad rows.
    Returns (rows int32, nk, dsize, the suffix array)."""
    rng = np.random.default_rng([SEED, n, v, sorted(FAMILIES).index(family)])
    x = np.asarray(FAMILIES[family](rng, n, int(rng.integers(2, 4))),
                   np.int64)
    sa = suffix_array_doubling(x)
    tabs = cover_tables(v)
    rank = np.full(n + v, -1, np.int64)
    sample = tabs.in_D[np.arange(n) % v]
    inv = np.empty(n, np.int64)
    inv[sa] = np.arange(n)
    rank[:n][sample] = inv[sample]
    xp = np.concatenate([x, np.full(v, -1)])
    pos = np.arange(n)
    chars = xp[pos[:, None] + np.arange(v)[None, :]].astype(np.int32)
    klass = pos % v
    rvals = rank[pos[:, None] + tabs.shifts[klass]]
    keys = chars
    if packed:
        sigma = psort.quantize_sigma(int(x.max()) + 1)
        keys = psort.pack_key_columns(_t(chars), -1, sigma).numpy()
    rows = np.concatenate([np.zeros((n, 1)), keys, rvals, klass[:, None],
                           pos[:, None]], axis=1).astype(np.int32)
    rows = rows[rng.permutation(n)]
    W = rows.shape[1]
    rows = np.concatenate([rows, np.asarray(jpsort.make_pad_rows(5, W))])
    return rows, keys.shape[1], len(tabs.D), sa


def _lam(v: int):
    tabs = cover_tables(v)
    return ((jnp.asarray(tabs.lam_idx1), jnp.asarray(tabs.lam_idx2)),
            (_t(tabs.lam_idx1.astype(np.int64)),
             _t(tabs.lam_idx2.astype(np.int64))))


@functools.lru_cache(maxsize=None)
def _jax_local_sort(impl: str, nk: int, v: int, dsize: int):
    """The reference's local sort, jitted once per layout (the families
    share a shape, so they share one compile)."""
    (jl1, jl2), _ = _lam(v)
    if impl == "bitonic":
        return jax.jit(jpsort.make_local_sort_bitonic(
            jpsort.make_payload_lt(nk, v, dsize, jl1, jl2)))
    return jax.jit(jpsort.make_local_sort_keyed(nk, v, dsize, jl1, jl2))


@pytest.mark.parametrize("family,v", [(f, 3) for f in sorted(FAMILIES)]
                         + [("all_equal", 5), ("periodic", 5)])
@pytest.mark.parametrize("impl", ["radix", "torch", "bitonic"])
def test_local_sorts_match_jax_on_lemma1_ties(family, v, impl):
    n = v * (40 if impl == "bitonic" else 80)
    rows, nk, dsize, sa = _payload(family, n, v, packed=impl == "radix")
    heads = rows[:n, :1 + nk]
    assert len(np.unique(heads, axis=0)) < n, "no equal-window run to break"
    (jl1, jl2), (tl1, tl2) = _lam(v)
    jlt = jpsort.make_payload_lt(nk, v, dsize, jl1, jl2)
    tlt = psort.make_payload_lt(nk, v, dsize, tl1, tl2)
    want = _jax_local_sort(impl, nk, v, dsize)(jnp.asarray(rows))
    if impl == "bitonic":
        got = psort.make_local_sort_bitonic(tlt)(_t(rows))
    else:
        got = psort.make_local_sort_keyed(nk, v, dsize, tl1, tl2,
                                          psort.key_sort_of(impl))(_t(rows))
    _eq(got, want)
    np.testing.assert_array_equal(got[:n, -1].numpy(), sa)

    rng = np.random.default_rng(n)
    a, b = rows[rng.integers(0, len(rows), 400)], rows[
        rng.integers(0, len(rows), 400)]
    _eq(tlt(_t(a), _t(b)), jlt(jnp.asarray(a), jnp.asarray(b)))
    spl = np.asarray(want)[np.sort(rng.integers(0, len(rows), 7))]
    _eq(primitives.searchsorted_rows(_t(spl), _t(rows), tlt),
        jprim.searchsorted_rows(jnp.asarray(spl), jnp.asarray(rows), jlt))


@pytest.mark.parametrize("key_sort", ["radix", "torch"])
def test_key_sorts_order_signed_and_pad_columns(key_sort):
    """`local_sort_lex` on rows with negative values, INT32_MAX pad rows
    and constant columns equals the reference's variadic key sort."""
    rng = np.random.default_rng(SEED)
    rows = np.concatenate([
        np.stack([np.zeros(300), rng.integers(-2, 3, 300),
                  np.full(300, 7), rng.integers(-2 ** 31, 2 ** 31 - 1, 300),
                  rng.permutation(300)], axis=1),
        np.asarray(jpsort.make_pad_rows(20, 5))]).astype(np.int32)
    rows = rows[rng.permutation(len(rows))]
    _eq(psort.local_sort_lex(_t(rows), key_sort),
        jpsort.local_sort_lex(jnp.asarray(rows)))


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize("n", [500, 3000, 100_000, 14_667_776])
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("impl", ["auto", "radix", "torch", "bitonic"])
def test_estimate_costs_log_matches_jax(n, p, impl):
    for sigma, base, pack in [(256, None, True), (2, 64, False),
                              (2 ** 20, 1000, True)]:
        kw = {"sigma": sigma, "base_threshold": base, "pack_keys": pack,
              "sort_impl": impl}
        got = tsa.estimate_costs(n, p, **kw)
        want = jsa.estimate_costs(
            n, p, **{**kw, "sort_impl": REF_IMPL.get(impl, impl)})
        assert got.log == want.log
        assert got.summary() == want.summary()
    assert tsa.estimate_costs(n, p, schedule=fixed_next_v).log == \
        jsa.estimate_costs(n, p, schedule=fixed_next_v).log


def test_round_geometry_matches_jax():
    for n, p, v in [(1500, 8, 3), (14_667_776, 8, 3), (1000, 3, 7),
                    (9_781_184, 8, 5)]:
        got, want = tsa.round_geometry(n, p, v), jsa.round_geometry(n, p, v)
        assert got[:4] == want[:4]


# ------------------------------------------- legacy single-device bitonic
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n,bucket", [(300, False), (2500, True)])
def test_legacy_bitonic_suffix_array_matches_jax(family, n, bucket):
    rng = np.random.default_rng([SEED, n, sorted(FAMILIES).index(family)])
    x = np.asarray(FAMILIES[family](rng, n, int(rng.integers(2, 64))),
                   np.int64)
    want = dcv_jax.suffix_array_jax(x, sort_impl="bitonic", bucket=bucket)
    got = suffix_array_torch(x, sort_impl="bitonic", device="cpu")
    _eq(got, want)
    _eq(build_suffix_array(x, SAOptions(sort_impl="bitonic"), device="cpu"),
        want)
