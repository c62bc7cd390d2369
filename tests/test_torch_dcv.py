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
from repro_torch.api import (SAOptions, build_suffix_array,
                             builder_cache_stats, clear_builder_cache,
                             registered_backends)
from repro_torch.bsp.counters import BSPCounters
from repro_torch.core import dcv_torch
from repro_torch.core.compat import resolve_sort_impl
from repro_torch.core.dcv_torch import suffix_array_torch

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
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", [300, 2500])
@pytest.mark.parametrize("impl", ["kernel", "torch", "radix"])
@pytest.mark.parametrize("bucket", [False, True])
def test_suffix_array_matches_jax(family, n, impl, bucket):
    x = _text(family, n)
    want = dcv_jax.suffix_array_jax(x, sort_impl="radix", bucket=bucket)
    got = suffix_array_torch(x, sort_impl=impl, bucket=bucket, device="cpu")
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
    words = dcv_torch._window_words(x, 6, 3, lo, hi)
    assert len(words) == 3                   # 32 bits: one column per word
    assert all(bool((w >= 0).all()) for w in words)
    small = dcv_torch._window_words(x.clamp(max=9), 6, 3, 0, 9)
    assert len(small) == 1                   # 4 bits: all three in one word


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("v", [3, 7])
def test_radix_window_order_equals_torch(family, v):
    # the radix order itself, not only the SA: equal windows stay in
    # position order, as the stable torch.sort passes keep them
    x = torch.as_tensor(_text(family, 1500))
    n_v = v * -(-len(x) // v)
    xp = dcv_torch._padded_text(x, n_v, v)
    lo, hi = -(n_v + 2 * v - len(x)), int(x.max())
    got = dcv_torch._window_order(xp, n_v, v, lo, hi, "radix")
    want = dcv_torch._window_order(xp, n_v, v, lo, hi, "torch")
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)


def test_word_bits_match_the_packing():
    for lo, hi, v in ((0, 9, 3), (-4, 2 ** 31 - 1, 3), (-12_295, 4_351, 3),
                      (-7, 300, 20)):
        x = (torch.arange(4 * v, dtype=torch.int64) + lo).clamp(max=hi)
        x[v:2 * v] = hi                      # a window of maxima
        words = dcv_torch._window_words(x, 2 * v, v, lo, hi)
        bits = dcv_torch._word_bits(v, lo, hi)
        assert len(bits) == len(words)
        assert all(int(w.max()) < 2 ** b for w, b in zip(words, bits))
    assert dcv_torch._word_bits(3, -12_295, 4_351) == [45]   # level 0


@pytest.mark.parametrize("n", [2, 3, 17, 200, 256])
def test_doubling_base_case_matches_oracle(n):
    rng = np.random.default_rng(SEED + n)
    x = rng.integers(0, 3, n)
    got = dcv_torch.suffix_array_doubling_torch(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), suffix_array_doubling(x))


@pytest.mark.parametrize("kind", ["random", "all_starts", "one_run"])
def test_run_state_matches_numpy(kind):
    # the tie-run bookkeeping of `_resolve_ties`, against the reference's
    # numpy form (start_slot[run_id], sizes[run_id])
    rng = np.random.default_rng(SEED + 2)
    is_start = {"random": rng.random(1000) < 0.3,
                "all_starts": np.ones(1000, bool),
                "one_run": np.zeros(1000, bool)}[kind]
    is_start[0] = True
    start_slot = np.flatnonzero(is_start)
    run_id = np.cumsum(is_start) - 1
    sizes = np.diff(start_slot, append=len(is_start))
    run_start, run_size = dcv_torch._run_state(torch.from_numpy(is_start))
    np.testing.assert_array_equal(run_start.numpy(), start_slot[run_id])
    np.testing.assert_array_equal(run_size.numpy(), sizes[run_id])


def test_pad_bucket_matches_jax():
    for n in list(range(1, 3000, 7)) + [14_680_064, 14_680_065, 2 ** 24]:
        assert dcv_torch.pad_bucket(n) == dcv_jax.pad_bucket(n), n


@pytest.mark.parametrize("v", [3, 4, 5, 8, 14])
def test_level_constants_match_jax(v):
    n_v = 12 * v
    sp, inv, in_d, shifts, lam1, lam2 = dcv_torch._level_constants(
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


def test_builder_cache_shares_bucketed_plans():
    clear_builder_cache()
    x = _text("uniform", 1100)
    build_suffix_array(x, device="cpu")
    build_suffix_array(x[:1050], SAOptions(sort_impl="kernel"), device="cpu")
    stats = builder_cache_stats()
    assert stats == {"entries": 1, "hits": 1, "misses": 1}
    build_suffix_array(x, SAOptions(sort_impl="torch"), device="cpu")
    assert builder_cache_stats()["entries"] == 2


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
