"""The port's radix histogram, pass counts and LSD radix argsort
(`repro_torch.kernels.ops` on CPU tensors, i.e. the plain versions in
`repro_torch.kernels.ref`) held against the JAX package's histogram oracle
(`repro.kernels.ref.radix_histogram_ref`), its Pallas kernel in interpret
mode (`radix_histogram_pallas`), its wrapper (`repro.kernels.ops`) and
`numpy.lexsort`, at the sweeps of tests/kernels/test_kernel_parity.py and
tests/kernels/test_kernels.py. The pass counts (the key loader's
contract) are held against the staged-digit route they replace, counted by
the oracle and by the Pallas kernel.

Inputs are made with numpy from a seed; every comparison is on integers and
exact (tolerance 0). The CUDA kernels themselves are held against these
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dcv_jax
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.radix_hist import radix_histogram_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.radix_hist import (radix_histogram_cuda,
                                            radix_pass_counts_cuda)
from repro_torch.kernels.radix_scatter import radix_scatter_cuda
from torch_pass_keys import PASS_KINDS, pass_keys

SEED = 20261017


def _eq(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_hist_parity(digits, n_bins, block):
    d_np = np.asarray(digits, np.int32)
    d = torch.from_numpy(d_np)
    per_block = ops.radix_histogram_blocks(d, n_bins, block)
    _eq(per_block, jref.radix_histogram_ref(jnp.asarray(d_np), n_bins, block))
    _eq(per_block, radix_histogram_pallas(jnp.asarray(d_np), n_bins,
                                          block=block))
    _eq(ref.radix_histogram_ref(d, n_bins, block), per_block)
    _eq(ops.radix_histogram(d, n_bins, block),
        jops.radix_histogram(jnp.asarray(d_np), n_bins, block=block))


# ------------------------------------------------------------- histograms
@pytest.mark.parametrize("n,bins,block", [
    (1024, 256, 256), (2048, 8, 1024), (512, 2, 128), (4096, 128, 512),
    (256, 16, 256),           # single block: n == block
    (128, 1, 64),             # degenerate single-bin histogram
])
def test_radix_histogram_shape_sweep(n, bins, block):
    rng = np.random.default_rng(n + bins + block)
    _assert_hist_parity(rng.integers(0, bins, n), bins, block)


def test_radix_histogram_constant_digits():
    _assert_hist_parity(np.full(1024, 5, np.int32), 8, 256)


def test_radix_histogram_boundary_digits():
    d = np.where(np.arange(2048) % 2 == 0, 0, 255).astype(np.int32)
    _assert_hist_parity(d, 256, 512)


def test_radix_histogram_skewed_blocks():
    # each block holds a single distinct digit: per-block rows are one-hot
    d = np.repeat(np.arange(8, dtype=np.int32), 256)
    got = ops.radix_histogram_blocks(torch.from_numpy(d), 8, 256)
    _eq(got, np.eye(8, dtype=np.int32) * 256)
    _eq(got, radix_histogram_pallas(jnp.asarray(d), 8, block=256))


@pytest.mark.parametrize("n,bins,block", [
    (2048, 256, 1024), (1024, 16, 256), (4096, 64, 512), (999, 8, 128),
    (128, 2, 128),
])
def test_radix_histogram_global(n, bins, block):
    # the wrapper's pad rule (999 is not a multiple of 128)
    rng = np.random.default_rng(n + bins)
    d = rng.integers(0, bins, n).astype(np.int32)
    got = ops.radix_histogram(torch.from_numpy(d), bins, block)
    _eq(got, np.bincount(d, minlength=bins))
    _eq(got, jops.radix_histogram(jnp.asarray(d), bins, block=block))
    blocks = ops.radix_histogram_blocks(torch.from_numpy(d), bins, block)
    assert blocks.shape == (-(-n // block), bins)


def test_radix_histogram_ignores_out_of_range_digits():
    # the one-hot contract: a digit outside [0, n_bins) counts nowhere
    d = np.array([-1, 0, 3, 4, 9, 3, 2, 100], np.int32)
    _eq(ref.radix_histogram_ref(torch.from_numpy(d), 4, 4),
        jref.radix_histogram_ref(jnp.asarray(d), 4, 4))


# ------------------------------------------- pass counts from the keys
def _staged_digits(keys, shift, block):
    """The earlier `lsd_argsort` staging: int32 digits padded to whole blocks
    with the scratch bin 256."""
    nb = -(-len(keys) // block)
    digits = np.full(nb * block, 256, np.int32)
    digits[:len(keys)] = (keys >> shift) & 255
    return digits


def _zero_led_bin_major(per_block):
    """[nb, 257] per-block histograms -> the pass counts' layout: the pad
    bin dropped, transposed to bin-major, flattened and led by 0."""
    flat = np.asarray(per_block)[:, :256].T.reshape(-1)
    return np.concatenate([[0], flat]).astype(np.int32)


@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("n", [1, 2, 999, 4096, 4097, 70_001])
@pytest.mark.parametrize("shift", [0, 8, 16, 40, 56])
def test_radix_pass_counts_ref_matches_the_staged_route(shift, n, block):
    # the key loader's plain version against the route it replaces: staged
    # digits counted by the JAX oracle and by the Pallas kernel in
    # interpret mode (one call over the four key kinds' digits, each
    # padded to whole blocks, so block rows stay apart)
    rng = np.random.default_rng([SEED, shift, n, block])
    keys = {kind: pass_keys(kind, n, rng) for kind in PASS_KINDS}
    staged = np.concatenate([_staged_digits(k, shift, block)
                             for k in keys.values()])
    oracle = np.asarray(jref.radix_histogram_ref(jnp.asarray(staged), 257,
                                                 block))
    pallas = np.asarray(radix_histogram_pallas(jnp.asarray(staged), 257,
                                               block=block))
    np.testing.assert_array_equal(pallas, oracle)
    nb = -(-n // block)
    for i, (kind, k) in enumerate(keys.items()):
        got = ref.radix_pass_counts_ref(torch.from_numpy(k), shift, block)
        assert got.shape == (256 * nb + 1,), kind
        _eq(got, _zero_led_bin_major(oracle[i * nb:(i + 1) * nb]))
        _eq(ops.radix_pass_counts(torch.from_numpy(k), shift, block), got)


@pytest.mark.parametrize("kind", PASS_KINDS)
@pytest.mark.parametrize("n", [2, 999, 4097, 70_001])
@pytest.mark.parametrize("block", [1024, 4096])
def test_radix_pass_counts_scan_gives_the_old_offsets(kind, n, block):
    # one inclusive int32 cumsum of the zero-led counts equals the earlier
    # `lsd_argsort` exclusive scan (transpose, cumsum, minus the counts), bit
    # for bit, and is the contiguous [256, nb] view the scatter takes
    rng = np.random.default_rng([SEED, n, block, len(kind)])
    keys = torch.from_numpy(pass_keys(kind, n, rng))
    nb = -(-n // block)
    for shift in (0, 8, 40, 56):
        counts = ref.radix_pass_counts_ref(keys, shift, block)
        scan = torch.cumsum(counts, 0, dtype=torch.int32)
        offsets = scan[:256 * nb].view(256, nb)
        per_block = ref.radix_histogram_ref(
            torch.from_numpy(_staged_digits(keys.numpy(), shift, block)),
            257, block)[:, :256]
        flat = per_block.t().reshape(-1)
        old = (torch.cumsum(flat, 0, dtype=torch.int32) - flat).view(256, nb)
        assert offsets.dtype == torch.int32 and offsets.is_contiguous()
        _eq(offsets, old.numpy())
        # the offsets make a stable counting pass (the scatter's contract)
        _, order = ops.radix_scatter(keys, torch.arange(n, dtype=torch.int32),
                                     shift, offsets, block)
        np.testing.assert_array_equal(
            order.numpy(),
            np.argsort((keys.numpy() >> shift) & 255, kind="stable"))


def test_radix_pass_counts_ref_edges():
    # no keys: just the leading zero; one key: one count in its digit's row
    assert ref.radix_pass_counts_ref(torch.zeros(0, dtype=torch.int64), 0,
                                     4096).tolist() == [0]
    one = ref.radix_pass_counts_ref(torch.tensor([0x1234]), 8, 4096)
    assert one.shape == (257,) and one.sum() == 1 and one[1 + 0x12] == 1


def test_lsd_argsort_counts_each_pass_from_the_keys():
    # one count and one scatter a pass, both handed the int64 keys and the
    # pass's shift: no digits are staged between them
    rng = np.random.default_rng(SEED + 5)
    words = [torch.from_numpy(rng.integers(0, 2 ** b, 3000))
             for b in (45, 30, 3)]
    counted, scattered = [], []

    def count(keys, shift, block):
        assert keys.dtype == torch.int64 and keys.shape == (3000,)
        counted.append(shift)
        return ref.radix_pass_counts_ref(keys, shift, block)

    def scatter(keys, payload, shift, offsets, block, *, write_keys):
        scattered.append(shift)
        return ref.radix_scatter_ref(keys, payload, shift, offsets, block,
                                     write_keys=write_keys)

    got = ref.lsd_argsort(words, [45, 30, 3], count, scatter, 1024)
    np.testing.assert_array_equal(got.numpy(), _lexsort(words))
    passes = [0] + list(range(0, 32, 8)) + list(range(0, 48, 8))
    assert counted == scattered == passes


# ----------------------------------------------------------- scatter pass
@pytest.mark.parametrize("kind", ["random", "constant", "distinct"])
@pytest.mark.parametrize("n,block", [(1000, 256), (3072, 1024), (1, 512)])
def test_radix_scatter_is_a_stable_counting_pass(kind, n, block):
    rng = np.random.default_rng(SEED + n)
    keys = {"random": rng.integers(0, 2 ** 40, n),
            "constant": np.full(n, 77 << 16),
            "distinct": rng.permutation(n) << 16}[kind].astype(np.int64)
    shift = 16
    digit = (keys >> shift) & 255
    nb = -(-n // block)
    counts = np.zeros((256, nb), np.int64)
    np.add.at(counts, (digit, np.arange(n) // block), 1)
    offsets = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(
        256, nb).astype(np.int32)
    payload = torch.arange(n, dtype=torch.int32)
    k_out, p_out = ops.radix_scatter(torch.from_numpy(keys), payload, shift,
                                     torch.from_numpy(offsets), block)
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(p_out.numpy(), order)
    np.testing.assert_array_equal(k_out.numpy(), keys[order])
    none, p_only = ops.radix_scatter(torch.from_numpy(keys), payload, shift,
                                     torch.from_numpy(offsets), block,
                                     write_keys=False)
    assert none is None and torch.equal(p_only, p_out)


# ---------------------------------------------------------- LSD argsort
def _lexsort(words):
    return np.lexsort([w.numpy() for w in reversed(words)])


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("kind", ["random", "all_equal", "wide31",
                                  "multiword", "62bit"])
def test_radix_argsort_matches_lexsort(n, kind):
    rng = np.random.default_rng([SEED, n, len(kind)])
    if kind == "random":
        bits, words = 12, [rng.integers(0, 2 ** 12, n)]
    elif kind == "all_equal":
        bits, words = 20, [np.full(n, 12345)]
    elif kind == "wide31":
        bits, words = 31, [rng.integers(2 ** 31 - 64, 2 ** 31, n)]
    elif kind == "multiword":
        bits, words = 9, [rng.integers(0, 4, n), rng.integers(0, 512, n),
                          rng.integers(0, 3, n)]
    else:
        bits, words = 62, [rng.integers(0, 2 ** 62, n) | (1 << 61)]
    words = [torch.from_numpy(np.asarray(w, np.int64)) for w in words]
    got = ops.radix_argsort(words, bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _lexsort(words))
    np.testing.assert_array_equal(ref.radix_argsort_ref(words, bits).numpy(),
                                  got.numpy())


def test_radix_argsort_takes_a_width_per_word():
    rng = np.random.default_rng(SEED)
    words = [torch.from_numpy(rng.integers(0, 2 ** b, 3000))
             for b in (45, 30, 3)]
    np.testing.assert_array_equal(
        ops.radix_argsort(words, [45, 30, 3]).numpy(), _lexsort(words))
    with pytest.raises(ValueError, match="key_bits"):
        ops.radix_argsort(words, [45, 64, 3])
    with pytest.raises(ValueError, match="key_bits"):
        ops.radix_argsort(words, [45, 30])


def test_radix_argsort_empty():
    assert ops.radix_argsort([torch.zeros(0, dtype=torch.int64)], 8).numel() \
        == 0


def test_radix_argsort_block_sizes_agree():
    # the offset scan is bin-major, block-minor: any block size gives the
    # same stable order
    rng = np.random.default_rng(SEED + 3)
    words = [torch.from_numpy(rng.integers(0, 50, 4099))]
    want = _lexsort(words)
    for block in (256, 512, 2048):
        np.testing.assert_array_equal(
            ops.radix_argsort(words, 6, block=block).numpy(), want)


@pytest.mark.parametrize("n", [ref.SORT_BLOCK - 1, ref.SORT_BLOCK,
                               3 * ref.SORT_BLOCK + 77])
@pytest.mark.parametrize("kind", ["distinct", "ties"])
def test_radix_argsort_ref_at_sort_block_matches_jax_order(n, kind):
    # the JAX radix impl's host sort (`dcv_jax._order_from_words`) leaves
    # ties in any order inside a run; the LSD sort keeps them in position
    # order, so runs must hold the same positions, ascending here
    rng = np.random.default_rng([SEED, n, len(kind)])
    if kind == "distinct":
        bits, words = 40, [rng.permutation(n) * 977 + 5]
    else:
        bits, words = 10, [rng.integers(0, 6, n), rng.integers(0, 1024, n)]
    words = [np.asarray(w, np.int64) for w in words]
    got = ref.radix_argsort_ref([torch.from_numpy(w) for w in words], bits,
                                ref.SORT_BLOCK).numpy()
    want, is_start = dcv_jax._order_from_words(words)
    for w in words:
        np.testing.assert_array_equal(w[got], w[want])
    run_id = np.cumsum(is_start) - 1
    for r in np.unique(run_id):
        in_run = run_id == r
        np.testing.assert_array_equal(got[in_run], np.sort(want[in_run]))
    if kind == "distinct":
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- device dispatch
def test_radix_cpu_tensors_never_count_as_kernel_launches():
    before = dict(ops.LAUNCHES)
    words = [torch.arange(3000, dtype=torch.int64) % 7]
    ops.radix_argsort(words, 3)
    ops.radix_histogram(torch.zeros(3000, dtype=torch.int32), 4)
    assert ops.LAUNCHES == before


def test_radix_pass_counts_refuses_non_cuda_tensors():
    keys = torch.zeros(1024, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        radix_pass_counts_cuda(keys, 0, 1024)
    before = dict(ops.LAUNCHES)
    ops.radix_pass_counts(keys, 0, 1024)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        ops.radix_pass_counts(torch.empty(8, dtype=torch.int64,
                                          device="meta"), 0)


def test_radix_launchers_refuse_non_cuda_tensors():
    d = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        radix_histogram_cuda(d, 256, 1024)
    keys = torch.zeros(1024, dtype=torch.int64)
    offsets = torch.zeros((256, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        radix_scatter_cuda(keys, d, 0, offsets, 1024)
    meta = torch.empty(1024, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.radix_argsort([meta], 8)
    with pytest.raises(ValueError, match="device"):
        ops.radix_histogram(meta.int(), 4)
