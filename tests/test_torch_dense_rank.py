"""The one-pass dense rank (`repro_torch.kernels.ops.dense_rank_sorted` and
`dense_rank_gathered`, their plain versions on the CPU) held against the
JAX package: `repro.kernels.ops.dense_rank_sorted` (the Pallas
`seg_boundary` kernel in interpret mode and its block stitch) for sorted
rows, and `repro.core.dcv_jax._rows_neq` with `np.cumsum` for rows gathered
through an order. Inputs are made with numpy from a seed; every comparison
is on integers and exact (tolerance 0). The kernels themselves run only on
the card (`tests/test_torch_gpu.py`).
"""
import ast
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dcv_jax
from repro.kernels import ops as jops
from repro_torch.core import dcv_torch
from repro_torch.core.difference_cover import difference_cover
from repro_torch.core.seq_ref import accelerated_next_v
from repro_torch.core.words import argsort_words, word_bits
from repro_torch.kernels import _build, dense_rank, ops

REPO = Path(__file__).resolve().parent.parent
SEED = 20261017


def _families():
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _families()


def _sorted_rows(rng, n, w, hi):
    rows = rng.integers(-hi, hi, (n, w)).astype(np.int32)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_rows_match_jax(rows, num_keys=None):
    got, nd = ops.dense_rank_sorted(torch.from_numpy(rows), num_keys)
    want, want_nd = jops.dense_rank_sorted(jnp.asarray(rows), num_keys)
    assert got.dtype == torch.int32 and nd.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(nd) == int(want_nd)


# ------------------------------------------------------------ sorted rows
@pytest.mark.parametrize("n", [1, 2, 511, 512, 513, 4097])
@pytest.mark.parametrize("w", [1, 3, 5])
def test_dense_rank_sorted_matches_jax(n, w):
    rows = _sorted_rows(np.random.default_rng([SEED, n, w]), n, w, hi=3)
    _assert_rows_match_jax(rows)
    if w == 5:                                  # a key prefix
        _assert_rows_match_jax(rows, num_keys=2)


@pytest.mark.parametrize("kind", ["all_equal", "all_distinct", "straddle"])
def test_dense_rank_sorted_edge_rows_match_jax(kind):
    n = 4097
    if kind == "all_equal":
        rows = np.full((n, 3), 9, np.int32)
    elif kind == "all_distinct":
        rows = np.arange(n, dtype=np.int32)[:, None].repeat(3, 1)
    else:
        # runs of 300 rows: many cross a 512-row block edge, where the
        # Pallas kernel forces a boundary and its stitch takes it back
        rows = (np.arange(n, dtype=np.int32) // 300)[:, None].repeat(2, 1)
    _assert_rows_match_jax(rows)


# -------------------------------------------------------- gathered rows
def _oracle(words: list[np.ndarray], pos: np.ndarray):
    """The reference's radix path: `_rows_neq` between neighbours along
    `pos`, then a cumsum."""
    is_start = np.ones(len(pos), dtype=bool)
    if len(pos) > 1:
        is_start[1:] = dcv_jax._rows_neq(words, pos[1:], pos[:-1])
    ranks = np.cumsum(is_start) - 1
    return ranks, is_start, int(is_start.sum())


def _window_words(family: str, n: int, v: int, top: int):
    """`window_words` of a FAMILIES text (alphabet below 64) lifted so its
    largest value is `top` (0: not lifted), v columns a row: `top` sets the
    bits a column takes."""
    rng = np.random.default_rng([SEED, n, v, sorted(FAMILIES).index(family)])
    x = np.asarray(FAMILIES[family](rng, n, int(rng.integers(2, 64))),
                   np.int64)
    if top:
        x += top - x.max()
    xt = torch.from_numpy(x)
    n_v = v * -(-n // v)
    xp = dcv_torch.padded_text(xt, n_v, v)
    lo, hi = -(n_v + 2 * v - n), int(x.max())
    return dcv_torch.window_words(xp, n_v, v, lo, hi)[0], rng


def _assert_gathered_match(words, pos):
    got = ops.dense_rank_gathered(words, pos)
    want = _oracle([w.numpy() for w in words], pos.numpy())
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32 and got[2].dim() == 0
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert int(got[2]) == want[2]


# (v, top, words a row): 3 columns of at most 7 bits in one word; 12 of 7
# bits in two; 12 of 32 bits (an alphabet up to 2^31 - 1) one a word
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("v,top,k", [(3, 0, 1), (12, 100, 2),
                                     (12, 2 ** 31 - 1, 12)])
def test_dense_rank_gathered_matches_jax(family, v, top, k):
    words, rng = _window_words(family, 1500, v, top)
    assert len(words) == k
    order = argsort_words(words, None, "torch")
    # the window order's run starts, a sorted subsequence as the sample
    # ranks take, the same positions in no order, and one row
    samples = order[torch.from_numpy(np.sort(
        rng.choice(len(order), len(order) // 3, replace=False)))]
    perm = torch.from_numpy(rng.permutation(len(order)))
    for pos in (order, samples, order[perm], order[:1]):
        _assert_gathered_match(words, pos)


# ----------------------------------------------------- the gathered cap
def _largest_words(n: int) -> int:
    """The most words `window_words` packs at any level of a build of n
    tokens under the accelerated v-schedule, with every level's alphabet at
    its largest (2^31 - 1 at the top, m - 1 below)."""
    hi, v, most = 2 ** 31 - 1, 3, 0
    while n > max(256, v, 4):
        v = int(min(max(v, 3), n))
        n_v = v * -(-n // v)
        lo = -(n_v + 2 * v - n)
        most = max(most, len(word_bits([(hi - lo).bit_length()] * v)))
        d = len(difference_cover(v))
        m = d * (n_v // v)
        n, v, hi = m, accelerated_next_v(v, d, m), m - 1
    return most


def test_gather_cap_is_the_schedules_largest_word_count():
    cap = _largest_words(2 ** 31 - 1)
    assert cap == dense_rank.MAX_WORDS
    src = (_build.CSRC / "dense_rank.cu").read_text()
    assert int(re.search(r"kMaxWords = (\d+);", src).group(1)) == cap
    assert _largest_words(14_680_065) < cap


# ------------------------------------------------------ wrappers, build
def test_dense_rank_kernels_are_built_and_counted():
    assert "dense_rank.cu" in _build.SOURCES
    assert {"dense_rank_rows", "dense_rank_gather"} <= set(ops.LAUNCHES)
    for name in ("repro_dense_rank_rows", "repro_dense_rank_gather"):
        assert name in _build._SIGNATURES
    src = (_build.CSRC / "dense_rank.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == dense_rank.TILE_ROWS


def test_dense_rank_wrappers_refuse_what_the_kernel_does_not_take():
    rows = torch.zeros((8, 3), dtype=torch.int32)
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="CUDA"):
        dense_rank.dense_rank_rows_cuda(rows, 3)
    with pytest.raises(ValueError, match="CUDA"):
        dense_rank.dense_rank_gather_cuda([pos], pos)
    with pytest.raises(ValueError, match=str(dense_rank.MAX_WORDS)):
        dense_rank.dense_rank_gather_cuda(
            [pos] * (dense_rank.MAX_WORDS + 1), pos)
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.dense_rank_gathered([meta], meta)
    with pytest.raises(ValueError, match="device"):
        ops.dense_rank_sorted(rows.to("meta"))


def test_cpu_tensors_never_count_dense_rank_launches():
    before = dict(ops.LAUNCHES)
    ops.dense_rank_sorted(torch.zeros((600, 2), dtype=torch.int32))
    ops.dense_rank_gathered([torch.arange(600)], torch.arange(600))
    assert ops.LAUNCHES == before


def test_card_script_imports_neither_jax_nor_repro():
    # chip_dense_rank.py runs where only PyTorch is installed
    tree = ast.parse((REPO / "chip_dense_rank.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert "repro_torch.kernels" in names and "chip_smoke" in names
