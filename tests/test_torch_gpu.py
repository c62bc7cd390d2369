"""The port's CUDA kernels held against their plain PyTorch versions on the
card, element for element (tolerance 0), and a small build through them.

Marked `gpu`: without a CUDA device every test here skips (the fixture
decides, at run time). On a machine with one card run
``python -m pytest -m gpu tests/test_torch_gpu.py``. This file imports no
JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import SuffixArrayIndex
from repro_torch.core.dcv_torch import suffix_array_torch
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rows(rng, n, w, hi=5):
    return torch.from_numpy(rng.integers(-hi, hi, (n, w)).astype(np.int32))


@pytest.mark.parametrize("w", [2, 4, 9, 66])
@pytest.mark.parametrize("kj", [(2, 1), (64, 8), (512, 128), (4096, 1024),
                                (8192, 4096)])
def test_bitonic_stage_kernel_matches_plain(cuda, w, kj):
    rows = _rows(np.random.default_rng(w), 8192, w).to(cuda)
    k, j = kj
    for num_keys in (w, max(1, w // 2)):
        got = ops.bitonic_stage(rows, k, j, num_keys)
        torch.testing.assert_close(got, ref.bitonic_stage_ref(rows, k, j,
                                                              num_keys),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n", [2 ** 10, 2 ** 16])
def test_bitonic_sort_kernel_matches_plain(cuda, n):
    rows = _rows(np.random.default_rng(n), n, 4, hi=50).to(cuda)
    rows[:, 3] = torch.randperm(n, generator=torch.Generator().manual_seed(n)
                                ).to(cuda, torch.int32)
    before = ops.LAUNCHES["bitonic_stage"]
    got = ops.bitonic_sort(rows)
    stages = (n.bit_length() - 1) * n.bit_length() // 2
    assert ops.LAUNCHES["bitonic_stage"] - before == stages
    torch.testing.assert_close(got, ref.bitonic_sort_ref(rows), rtol=0,
                               atol=0)


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_distinct"])
@pytest.mark.parametrize("block", [32, 512, 1024])
def test_seg_boundary_kernel_matches_plain(cuda, kind, block):
    n = 4096
    if kind == "random":
        rows = ref.bitonic_sort_ref(_rows(np.random.default_rng(1), n, 3,
                                          hi=2))
    elif kind == "all_equal":
        rows = torch.full((n, 3), 7, dtype=torch.int32)
    else:
        rows = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, 2)
    rows = rows.to(cuda)
    for num_keys in (None, 1):
        for g, w in zip(ops.seg_boundary(rows, num_keys, block),
                        ref.seg_boundary_ref(rows, num_keys, block)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 511, 1300, 70_001])
def test_dense_rank_kernel_matches_plain(cuda, n):
    rows = ref.bitonic_sort_ref(_rows(np.random.default_rng(n), n, 3, hi=3))
    got, nd = ops.dense_rank_sorted(rows.to(cuda), 2)
    want, want_nd = ops.dense_rank_sorted(rows, 2)         # plain, on CPU
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert int(nd) == int(want_nd)


def test_small_build_goes_through_the_kernels(cuda):
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 4, 3000) for _ in range(4)]
    docs.append(docs[0][100:900])
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    idx = SuffixArrayIndex.from_docs(docs, device=cuda)
    assert all(v > 0 for v in ops.LAUNCHES.values())
    cpu = SuffixArrayIndex.from_docs(docs, device="cpu")
    torch.testing.assert_close(idx.sa.cpu(), cpu.sa, rtol=0, atol=0)
    x = np.asarray(idx.text.cpu())
    torch.testing.assert_close(
        suffix_array_torch(x, sort_impl="torch", device=cuda).cpu(), cpu.sa,
        rtol=0, atol=0)
    pats = [d[50:80] for d in docs] + [np.zeros(0, np.int64)]
    np.testing.assert_array_equal(idx.count_batch(pats),
                                  cpu.count_batch(pats))
    for a, b in zip(idx.locate_batch(pats[:-1]), cpu.locate_batch(pats[:-1])):
        np.testing.assert_array_equal(a, b)
