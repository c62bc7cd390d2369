"""The port's DC-v build (`repro_torch.core.dcv_torch`, `repro_torch.api`)
held against the JAX package's (`repro.core.dcv_jax`, `repro.api`).

Inputs are made with numpy from a seed and handed to both packages; every
comparison is on integers and exact (tolerance 0). The suffix array of a
text is unique, so the port's "kernel" and "torch" sort_impls (on the CPU,
"kernel" runs the kernels' plain PyTorch versions) are held to the
reference's "radix" build, and one small cell to its "pallas" build in
interpret mode. JAX stays on the CPU (tests/conftest.py).
"""
import ast
import importlib.util
from pathlib import Path

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import dcv_jax
from repro.core.oracle import suffix_array_doubling
from repro_torch.api import (SAOptions, SegmentedIndex, build_suffix_array,
                             registered_backends)
from repro_torch.bsp import psort
from repro_torch.bsp.counters import BSPCounters
from repro_torch.core import dcv_torch
from repro_torch.core.compat import resolve_sort_impl
from repro_torch.core.dcv_torch import suffix_array_torch
from repro_torch.core.words import (pack_words, run_starts, run_state,
                                    word_bits)
from repro_torch.trace import counters

REPO = Path(__file__).resolve().parent.parent
SEED = 20261017


def _load_families():
    """`FAMILIES` of tests/api/test_fuzz_differential.py, the seeded corpus
    generators of the cross-backend fuzz suite."""
    path = REPO / "tests" / "api" / "test_fuzz_differential.py"
    spec = importlib.util.spec_from_file_location("_fuzz_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


FAMILIES = _load_families()


def _text(family: str, n: int) -> np.ndarray:
    rng = np.random.default_rng([SEED, n, sorted(FAMILIES).index(family)])
    sigma = int(rng.integers(2, 64))
    return np.asarray(FAMILIES[family](rng, n, sigma), np.int64)


# ------------------------------------------------------ suffix array parity
# 513 and 2049 lie just above points of the JAX package's bucket grid,
# where its level padding is largest; the port builds every length as it is
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", [300, 513, 2049, 2500])
@pytest.mark.parametrize("impl", ["kernel", "torch", "radix"])
def test_suffix_array_matches_jax(family, n, impl):
    x = _text(family, n)
    want = dcv_jax.suffix_array_jax(x, sort_impl="radix", bucket=False)
    got = suffix_array_torch(x, sort_impl=impl, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_suffix_array_matches_jax_pallas():
    # the reference's own kernel path, in interpret mode (~15 s on a CPU)
    x = _text("periodic", 200)
    want = dcv_jax.suffix_array_jax(x, sort_impl="pallas", base_threshold=16)
    got = suffix_array_torch(x, sort_impl="kernel", base_threshold=16,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["kernel", "torch", "radix"])
@pytest.mark.parametrize("layout", ["top", "bottom_top"])
def test_wide_alphabet_matches_jax(impl, layout):
    # hi - lo near 2^31: one window column per packed int64 word on the
    # torch path, int32 columns at their limit on the kernel path
    rng = np.random.default_rng(SEED + 1)
    if layout == "top":
        x = rng.integers(2 ** 31 - 64, 2 ** 31 - 1, 2000)
    else:
        x = np.where(rng.random(2000) < 0.5, 0, 2 ** 31 - 2)
    x[1200:1500] = x[100:400]                 # a long repeat: deep ties
    want = dcv_jax.suffix_array_jax(x, sort_impl="radix")
    got = suffix_array_torch(x, sort_impl=impl, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_words_keep_the_sign_bit_clear():
    x = torch.tensor([0, 2 ** 31 - 1, 5, 2 ** 31 - 2, 0, 0, 0, 0, 0],
                     dtype=torch.int64)
    lo, hi = -4, 2 ** 31 - 1
    words, _ = dcv_torch.window_words(x, 6, 3, lo, hi)
    assert len(words) == 3                   # 32 bits: one column per word
    assert all(bool((w >= 0).all()) for w in words)
    small, _ = dcv_torch.window_words(x.clamp(max=9), 6, 3, 0, 9)
    assert len(small) == 1                   # 4 bits: all three in one word


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("v", [3, 7])
def test_radix_window_order_equals_torch(family, v):
    # the radix order itself, not only the SA: equal windows stay in
    # position order, as the stable torch.sort passes keep them
    x = torch.as_tensor(_text(family, 1500))
    n_v = v * -(-len(x) // v)
    xp = dcv_torch.padded_text(x, n_v, v)
    lo, hi = -(n_v + 2 * v - len(x)), int(x.max())
    got = dcv_torch.window_order(xp, n_v, v, lo, hi, "radix")
    want = dcv_torch.window_order(xp, n_v, v, lo, hi, "torch")
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)


def test_word_bits_match_the_packing():
    for lo, hi, v in ((0, 9, 3), (-4, 2 ** 31 - 1, 3), (-12_295, 4_351, 3),
                      (-7, 300, 20)):
        x = (torch.arange(4 * v, dtype=torch.int64) + lo).clamp(max=hi)
        x[v:2 * v] = hi                      # a window of maxima
        words, bits = dcv_torch.window_words(x, 2 * v, v, lo, hi)
        assert bits == word_bits([max(1, (hi - lo).bit_length())] * v)
        assert len(bits) == len(words)
        assert all(int(w.max()) < 2 ** b for w, b in zip(words, bits))
    assert word_bits([21] * 3) == [63]
    assert word_bits([22] * 3) == [44, 22]


def _per_word_window_words(xp, n_v, v, lo, hi):
    """The window packing as it was written before `core.words`: `63 //
    bits` columns a word, each word built from zeros."""
    bits = max(1, int(hi - lo).bit_length())
    per_word = max(1, 63 // bits)
    words, widths = [], []
    for start in range(0, v, per_word):
        stop = min(start + per_word, v)
        w = torch.zeros(n_v, dtype=torch.int64)
        for c in range(start, stop):
            w = (w << bits) | (xp[c:c + n_v] - lo)
        words.append(w)
        widths.append(bits * (stop - start))
    return words, widths


def _per_column_row_words(sel):
    """`bsp.psort.argsort_rows`' packing as it was written before
    `core.words`: per-column widths, constant columns skipped."""
    lo, hi = torch.aminmax(sel, dim=0)
    words, bits = [], []
    for c, span in enumerate((hi - lo).tolist()):
        width = int(span).bit_length()
        if not width:
            continue
        col = sel[:, c] - lo[c]
        if bits and bits[-1] + width <= 63:
            words[-1] = (words[-1] << width) | col
            bits[-1] += width
        else:
            words.append(col)
            bits.append(width)
    return words, bits


def test_pack_words_equals_the_per_word_rule():
    rng = np.random.default_rng(SEED + 3)
    for v in (3, 4, 5, 8, 14, 27):
        for top in (1, 9, 300, 2 ** 20, 2 ** 31 - 1):
            x = torch.from_numpy(rng.integers(0, top + 1, 40 * v))
            x[-1] = top
            n_v = v * -(-len(x) // v)
            xp = dcv_torch.padded_text(x, n_v, v)
            args = (xp, n_v, v, -(n_v + 2 * v - len(x)), top)
            words, bits = dcv_torch.window_words(*args)
            want, want_bits = _per_word_window_words(*args)
            assert bits == want_bits, (v, top)
            assert all(torch.equal(g, w) for g, w in zip(words, want))
    # a bsp row set: valid flag, keys of mixed widths, a constant column,
    # INT32_MAX pads, a unique index
    m = 500
    rows = np.stack([rng.integers(0, 2, m), rng.integers(-3, 40, m),
                     np.full(m, 7), rng.integers(0, 2 ** 30, m),
                     rng.integers(0, 5, m), np.arange(m)], 1)
    rows[-20:, 1:5] = 2 ** 31 - 1
    sel = torch.from_numpy(rows).int().long()
    want, want_bits = _per_column_row_words(sel)
    lo, hi = torch.aminmax(sel, dim=0)
    keep = [c for c in range(sel.shape[1]) if int(hi[c] - lo[c])]
    words, bits = pack_words((sel[:, c] - lo[c] for c in keep),
                             [int(hi[c] - lo[c]).bit_length() for c in keep])
    assert bits == want_bits == word_bits(
        [int(hi[c] - lo[c]).bit_length() for c in keep])
    assert all(torch.equal(g, w) for g, w in zip(words, want))
    for impl in ("radix", "torch"):
        np.testing.assert_array_equal(
            psort.argsort_rows(sel.int(), range(sel.shape[1]), impl).numpy(),
            np.lexsort(rows.T[::-1]))


@pytest.mark.parametrize("n", [2, 3, 17, 200, 256])
def test_doubling_base_case_matches_oracle(n):
    rng = np.random.default_rng(SEED + n)
    x = rng.integers(0, 3, n)
    got = dcv_torch.suffix_array_doubling_torch(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), suffix_array_doubling(x))


@pytest.mark.parametrize("kind", ["random", "all_starts", "one_run"])
def test_run_state_matches_numpy(kind):
    # the tie-run bookkeeping of `_resolve_ties` (and `run_starts`, the
    # start alone), against the reference's numpy form (start_slot[run_id],
    # sizes[run_id])
    rng = np.random.default_rng(SEED + 2)
    is_start = {"random": rng.random(1000) < 0.3,
                "all_starts": np.ones(1000, bool),
                "one_run": np.zeros(1000, bool)}[kind]
    is_start[0] = True
    start_slot = np.flatnonzero(is_start)
    run_id = np.cumsum(is_start) - 1
    sizes = np.diff(start_slot, append=len(is_start))
    run_start, run_size = run_state(torch.from_numpy(is_start))
    np.testing.assert_array_equal(run_start.numpy(), start_slot[run_id])
    np.testing.assert_array_equal(run_size.numpy(), sizes[run_id])
    np.testing.assert_array_equal(run_starts(torch.from_numpy(is_start)),
                                  start_slot[run_id])


@pytest.mark.parametrize("v", [3, 4, 5, 8, 14])
def test_level_constants_match_jax(v):
    n_v = 12 * v
    sp, inv, in_d, shifts, lam1, lam2 = dcv_torch.level_constants(
        n_v, v, torch.device("cpu"))
    ref = dcv_jax._level_constants(n_v, v)
    for got, want in zip((sp, inv, in_d, shifts, lam1, lam2), ref[:6]):
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the facade
@pytest.mark.parametrize("backend", ["oracle", "seq", "torch"])
def test_facade_backends_match_jax(backend):
    x = _text("uniform", 700)
    want = japi.build_suffix_array(x)
    got = build_suffix_array(x, SAOptions(backend=backend), device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_facade_edge_inputs():
    for x in ([], [7], [2, 2], np.full(40, 3)):
        want = japi.build_suffix_array(np.asarray(x, np.int64))
        got = build_suffix_array(np.asarray(x, np.int64), device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="≥ 0"):
        build_suffix_array([1, -1, 2], device="cpu")
    with pytest.raises(ValueError, match="2³¹"):
        build_suffix_array([1, 2 ** 31], device="cpu")
    with pytest.raises(TypeError):
        build_suffix_array([0.5, 1.0], device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        build_suffix_array(np.zeros((2, 2), np.int64), device="cpu")


def test_builds_counter_counts_backend_builds():
    def builds():
        return counters().get("repro_torch.builds", 0)

    x = _text("uniform", 1100)
    b0 = builds()
    build_suffix_array(x, device="cpu")
    build_suffix_array(x[:1050], SAOptions(sort_impl="kernel"), device="cpu")
    build_suffix_array(x, SAOptions(sort_impl="torch"), device="cpu")
    assert builds() == b0 + 3
    for short in ([], [7]):                  # n ≤ 1 reaches no backend
        build_suffix_array(np.asarray(short, np.int64), device="cpu")
    assert builds() == b0 + 3
    docs = [x[i:i + 100] for i in range(0, 500, 100)]
    SegmentedIndex.from_docs(docs, segment_docs=2, device="cpu")
    assert builds() == b0 + 3 + 3            # one build a segment


def test_options_validation_and_fingerprint():
    assert registered_backends() == ("bsp", "oracle", "seq", "torch")
    x = _text("periodic", 600)
    want = suffix_array_doubling(x)
    np.testing.assert_array_equal(
        build_suffix_array(x, SAOptions(sort_impl="bitonic"),
                           device="cpu").numpy(), want)
    for impl in ("lax", "pallas", "quantum"):
        with pytest.raises(ValueError, match="sort_impl"):
            SAOptions(sort_impl=impl)
    assert SAOptions(sort_impl="radix").sort_impl == "radix"
    assert resolve_sort_impl("auto", torch.device("cpu")) == "kernel"
    assert resolve_sort_impl("auto", torch.device("cuda")) == "radix"
    assert resolve_sort_impl("torch", torch.device("cuda")) == "torch"
    assert SAOptions(sample_rate=4).fingerprint().endswith("|rate=4")
    with pytest.raises(ValueError):
        SAOptions(sample_rate=0)
    with pytest.raises(ValueError):
        SAOptions(v0=2)
    # no mesh: one rank a device of the text's kind, p = 1 on the CPU
    counters = BSPCounters()
    np.testing.assert_array_equal(
        build_suffix_array(x, backend="bsp", counters=counters,
                           device="cpu").numpy(), want)
    assert counters.log == [{"label": "base/gather", "h": 600, "w": 2400}]
    kw = {"v0": 5, "schedule": "fixed", "base_threshold": 64}
    assert (SAOptions(**kw).fingerprint()
            == japi.SAOptions(**kw).fingerprint())
    assert SAOptions().resolve_backend() == "torch"


def test_no_cpu_fallback_without_device(monkeypatch):
    # entry points run on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(20) % 3
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_suffix_array(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suffix_array_torch(x)


def test_no_cpu_fallback_on_this_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError):
        build_suffix_array(np.arange(20) % 3)


# ------------------------------------------------------------- isolation
def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
