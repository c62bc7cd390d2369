"""The plain PyTorch versions of the port's kernels
(`repro_torch.kernels.ops` on CPU tensors) held against the JAX package's
pure-jnp oracles (`repro.kernels.ref`) and its Pallas kernels in interpret
mode (`repro.kernels.ops`, ``interpret=True``), at the shapes of
tests/kernels/test_kernels.py and tests/kernels/test_kernel_parity.py.

Inputs are made with numpy from a seed; every comparison is on integers and
exact (tolerance 0). The CUDA kernels themselves are held against these
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.seg_boundary import seg_boundary_pallas
from repro_torch.kernels import bitonic_sort as bsort
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic_sort import bitonic_launch_cuda, schedule
from repro_torch.kernels.bitonic_stage import bitonic_stage_cuda
from repro_torch.kernels.seg_boundary import seg_boundary_cuda


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sorted_rows(rng, n, w, lo=0, hi=5):
    rows = rng.integers(lo, hi, (n, w)).astype(np.int32)
    order = np.lexsort(tuple(rows[:, c] for c in range(w - 1, -1, -1)))
    return rows[order]


# ------------------------------------------------------------ bitonic stage
@pytest.mark.parametrize("n,w,tile", [(256, 3, 64), (512, 5, 128),
                                      (1024, 2, 256), (128, 8, 32)])
def test_bitonic_stage_matches_jax(n, w, tile):
    rng = np.random.default_rng(n * w)
    rows = rng.integers(-4, 9, (n, w)).astype(np.int32)
    rows[:, -1] = rng.permutation(n)          # a strict total order
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            got = ops.bitonic_stage(torch.from_numpy(rows), k, j)
            _eq(got, jref.bitonic_stage_ref(jnp.asarray(rows), k, j))
            _eq(got, jops.bitonic_stage(jnp.asarray(rows), k, j, tile=tile))
            j //= 4 if j >= 4 else 2          # sparse sweep for speed
        k *= 4


@pytest.mark.parametrize("n,w,tile", [(256, 3, 64), (128, 8, 32)])
def test_bitonic_sort_matches_jax(n, w, tile):
    rng = np.random.default_rng(n + w)
    rows = rng.integers(-4, 9, (n, w)).astype(np.int32)
    rows[:, -1] = rng.permutation(n)
    got = ops.bitonic_sort(torch.from_numpy(rows))
    _eq(got, jref.bitonic_sort_ref(jnp.asarray(rows)))
    _eq(got, jops.bitonic_sort(jnp.asarray(rows), tile=tile))
    _eq(ref.bitonic_sort_ref(torch.from_numpy(rows)),
        jref.bitonic_sort_ref(jnp.asarray(rows)))


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_bitonic_stage_num_keys_prefix(num_keys):
    # equal key prefixes with differing trailing columns: the element-wise
    # rule of the reference's `bitonic_stage_ref` holds for every pair
    rng = np.random.default_rng(num_keys)
    rows = rng.integers(0, 3, (256, 4)).astype(np.int32)
    for k, j in [(2, 1), (16, 4), (256, 128), (128, 64)]:
        got = ops.bitonic_stage(torch.from_numpy(rows), k, j, num_keys)
        _eq(got, jref.bitonic_stage_ref(jnp.asarray(rows), k, j, num_keys))


@pytest.mark.parametrize("n,w", [(1024, 4), (64, 66), (32, 9)])
def test_bitonic_sort_prefix_keys_matches_jax_oracle(n, w):
    # the dcv_torch layout: key columns + a unique index column
    rng = np.random.default_rng(w)
    rows = rng.integers(-3, 3, (n, w)).astype(np.int32)
    rows[:, -1] = rng.permutation(n)
    got = ops.bitonic_sort(torch.from_numpy(rows), num_keys=w)
    _eq(got, jref.bitonic_sort_ref(jnp.asarray(rows), w))


def test_bitonic_stage_inplace_and_copy():
    rows = torch.tensor([[3, 0], [1, 1], [2, 2], [0, 3]], dtype=torch.int32)
    before = rows.clone()
    out = ops.bitonic_stage(rows, 2, 1)
    assert torch.equal(rows, before) and out is not rows
    same = ops.bitonic_stage(rows, 2, 1, inplace=True)
    assert same is rows and torch.equal(rows, out)


# ---------------------------------------- bitonic sort in shared-memory runs
def _all_stages(n):
    k, out = 2, []
    while k <= n:
        j = k // 2
        while j >= 1:
            out.append((k, j))
            j //= 2
        k *= 2
    return out


@pytest.mark.parametrize("n,w", [(2 ** 24, 4), (2 ** 24, 5), (2 ** 24, 6),
                                 (2 ** 23, 9), (2 ** 22, 15), (2 ** 20, 187),
                                 (4096, 66), (2, 3), (1, 4)])
def test_bitonic_schedule_covers_every_stage_in_order(n, w):
    launches = schedule(n, w)
    assert [st for launch in launches for st in launch.stages()] == \
        _all_stages(n)
    t = bsort.tile_rows(n, w)
    assert t * (w | 1) * 4 <= bsort.SMEM_BUDGET
    for launch in launches:
        assert launch.rows == t and n % launch.rows == 0
        if launch.kind == "cross":      # every partner inside the block
            assert launch.j_lo >= t and launch.k_first == launch.k_last
            assert launch.run * (launch.j_hi // launch.j_lo) * 2 == t
        else:
            assert launch.j_hi == t // 2 and launch.j_lo == 1
    # the level shapes of chip_smoke.py's corpus: 30 launches in place of
    # 300 stages at 2^24 rows of W = 4
    if (n, w) == (2 ** 24, 4):
        assert len(launches) == 30 and len(_all_stages(n)) == 300


@pytest.mark.parametrize("w", [3, 9, 66, 187])
@pytest.mark.parametrize("num_keys", ["all", "prefix"])
def test_bitonic_stages_ref_equals_jax_stage_by_stage(w, num_keys):
    rng = np.random.default_rng(w)
    n = 64
    rows = rng.integers(0, 3, (n, w)).astype(np.int32)   # many equal keys
    nk = w if num_keys == "all" else max(1, w // 3)
    stages = [(2, 1), (8, 4), (8, 2), (64, 32), (64, 8), (64, 1)]
    got = ref.bitonic_stages_ref(torch.from_numpy(rows), stages, nk)
    want = jnp.asarray(rows)
    for k, j in stages:
        want = jref.bitonic_stage_ref(want, k, j, nk)
    _eq(got, want)


def _tile_cases():
    # N below, at and above the tile T at the real shared-memory budget
    for w in (3, 9, 66, 187):
        t = bsort.tile_rows(2 ** 30, w)
        for n in (t // 2, t, 4 * t):
            yield n, w


@pytest.mark.parametrize("n,w", list(_tile_cases()))
def test_bitonic_sort_schedule_matches_jax_oracle(n, w):
    rng = np.random.default_rng(n + w)
    rows = rng.integers(-4, 9, (n, w)).astype(np.int32)
    rows[:, -1] = rng.permutation(n)
    got = ops.bitonic_sort(torch.from_numpy(rows))
    _eq(got, jref.bitonic_sort_ref(jnp.asarray(rows)))


@pytest.mark.parametrize("n,w", [(8, 3), (16, 3), (64, 3), (64, 9)])
def test_bitonic_sort_small_tile_matches_pallas(monkeypatch, n, w):
    # a 16-row tile: N below, at and above it with cross-tile launches,
    # held against the Pallas kernels in interpret mode
    monkeypatch.setattr(bsort, "SMEM_BUDGET", 16 * (w | 1) * 4)
    assert bsort.tile_rows(n, w) == min(16, n)
    rng = np.random.default_rng(n * w)
    rows = rng.integers(-4, 9, (n, w)).astype(np.int32)
    rows[:, -1] = rng.permutation(n)
    got = ops.bitonic_sort(torch.from_numpy(rows))
    _eq(got, jops.bitonic_sort(jnp.asarray(rows), tile=min(16, n // 2)))
    _eq(got, jref.bitonic_sort_ref(jnp.asarray(rows)))


@pytest.mark.parametrize("n,w,budget_rows", [(256, 4, 16), (512, 9, 64),
                                             (128, 66, 8), (64, 187, 4)])
def test_bitonic_sort_prefix_keys_equals_stage_by_stage(monkeypatch, n, w,
                                                        budget_rows):
    # num_keys < W with duplicate keys: where keys tie but trailing columns
    # differ, the element-wise rule copies one row over the other, so the
    # launches must equal the reference's stages applied one by one
    monkeypatch.setattr(bsort, "SMEM_BUDGET", budget_rows * (w | 1) * 4)
    rng = np.random.default_rng(n + w)
    rows = rng.integers(0, 2, (n, w)).astype(np.int32)
    num_keys = max(1, w // 4)
    got = ops.bitonic_sort(torch.from_numpy(rows), num_keys)
    assert any(launch.kind == "cross" for launch in schedule(n, w))
    want = jnp.asarray(rows)
    for k, j in _all_stages(n):
        want = jref.bitonic_stage_ref(want, k, j, num_keys)
    _eq(got, want)


# ------------------------------------------------------------- seg boundary
def _assert_seg_parity(rows, block, num_keys=None):
    got = ops.seg_boundary(torch.from_numpy(rows), num_keys, block)
    want = jref.seg_boundary_ref(jnp.asarray(rows), num_keys, block)
    pallas = seg_boundary_pallas(jnp.asarray(rows), num_keys=num_keys,
                                 block=block)
    for g, r, p in zip(got, want, pallas):
        assert g.dtype == torch.int32
        _eq(g, r)
        _eq(g, p)


@pytest.mark.parametrize("n,w,block", [
    (256, 1, 64), (512, 3, 128), (1024, 4, 256), (2048, 2, 512),
    (512, 5, 512), (128, 8, 32),
])
def test_seg_boundary_shape_sweep(n, w, block):
    rng = np.random.default_rng(n * w + block)
    _assert_seg_parity(_sorted_rows(rng, n, w), block)


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_seg_boundary_num_keys_prefix(num_keys):
    rng = np.random.default_rng(num_keys)
    rows = _sorted_rows(rng, 512, 4, hi=3)
    rows[:, 3] = np.arange(512, dtype=np.int32)
    _assert_seg_parity(rows, block=128, num_keys=num_keys)


def test_seg_boundary_all_equal_and_all_distinct_rows():
    _assert_seg_parity(np.full((1024, 3), 7, np.int32), block=256)
    distinct = np.arange(512, dtype=np.int32)[:, None] * np.ones((1, 2),
                                                                 np.int32)
    _assert_seg_parity(distinct, block=128)


# ------------------------------------------------------- dense rank (stitch)
@pytest.mark.parametrize("n,w,block", [(1000, 3, 128), (512, 2, 512),
                                       (77, 4, 32), (4096, 1, 1024),
                                       (1537, 3, 512)])
def test_dense_rank_sorted_matches_jax(n, w, block):
    rng = np.random.default_rng(n + w)
    rows = _sorted_rows(rng, n, w)
    got, ndist = ops.dense_rank_sorted(torch.from_numpy(rows))
    want, want_n = jops.dense_rank_sorted(jnp.asarray(rows), block=block)
    assert got.dtype == torch.int32
    _eq(got, want)
    assert int(ndist) == int(want_n)


@pytest.mark.parametrize("kind", ["all_equal", "all_distinct", "prefix"])
def test_dense_rank_sorted_edge_rows(kind):
    n = 1300                                   # not a multiple of 512
    if kind == "all_equal":
        rows, num_keys = np.full((n, 3), 4, np.int32), None
    elif kind == "all_distinct":
        rows, num_keys = np.arange(n, dtype=np.int32)[:, None].repeat(2, 1), None
    else:
        rows = _sorted_rows(np.random.default_rng(3), n, 3, hi=4)
        rows[:, 2] = np.arange(n)               # ignored by num_keys=2
        num_keys = 2
    got, ndist = ops.dense_rank_sorted(torch.from_numpy(rows), num_keys)
    want, want_n = jops.dense_rank_sorted(jnp.asarray(rows), num_keys)
    _eq(got, want)
    assert int(ndist) == int(want_n)


# -------------------------------------------------------- device dispatch
def test_cpu_tensors_never_count_as_kernel_launches():
    before = dict(ops.LAUNCHES)
    rows = torch.zeros((512, 2), dtype=torch.int32)
    ops.bitonic_sort(rows)
    ops.dense_rank_sorted(rows)
    assert ops.LAUNCHES == before


def test_kernel_launchers_refuse_non_cuda_tensors():
    rows = torch.zeros((512, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_stage_cuda(rows, 2, 1, 2)
    for launch in schedule(512, 2)[:2]:
        with pytest.raises(ValueError, match="CUDA"):
            bitonic_launch_cuda(rows, launch, 2)
    with pytest.raises(ValueError, match="CUDA"):
        seg_boundary_cuda(rows, 2, 512)
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.bitonic_stage(meta, 2, 1)
    with pytest.raises(ValueError, match="device"):
        ops.bitonic_sort(meta)
    with pytest.raises(ValueError, match="device"):
        ops.seg_boundary(meta, block=4)
