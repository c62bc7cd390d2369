"""The DC-v recursion's counters (`repro_torch.core.dcv_torch`):
``repro_torch.dcv.levels``, ``.refine_rounds`` and ``.lemma1_rows`` equal
what a spy on `window_order`, `run_state` and `lemma1_order` sees, and
counting changes no output.

Two seeded texts: a tiny strain collection (37 near-copies of one base
sequence over four letters, each strain ended by its own separator),
whose ties the refinement rounds and Lemma 1 resolve, and an
infini-gram-like text (Zipf ids with a copied passage). Every suffix
array is held to the naive oracle (`repro_torch.core.oracle`). This file
imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dcv_torch
from repro_torch.core.oracle import suffix_array_doubling
from repro_torch.trace import counters

SEED = 20261031
PREFIX = "repro_torch.dcv."


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where the suite's
    workers share the cores, torch's default pool of one thread a core
    slows such tests fifteenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def strains(n_strains: int = 37, length: int = 300,
            rate: float = 0.005) -> np.ndarray:
    """`n_strains` copies of one base sequence (GC share 0.38), each with
    its own substitutions at `rate` a site, data shifted above the
    separators 0 .. n_strains - 1, strain k ended by separator k."""
    rng = np.random.default_rng([SEED, 1])
    base = rng.choice(4, length, p=[0.31, 0.19, 0.19, 0.31])
    hit = rng.random((n_strains, length)) < rate
    data = (base + hit * rng.integers(1, 4, (n_strains, length))) % 4
    text = np.concatenate([data + n_strains,
                           np.arange(n_strains)[:, None]], axis=1)
    return text.reshape(-1).astype(np.int64)


def infinigram_like(n: int = 6000, vocab: int = 32000) -> np.ndarray:
    """Zipf(1.0) ids over `vocab`, with one 200-token passage copied to
    three other places."""
    rng = np.random.default_rng([SEED, 2])
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1))
    x = np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(n)), vocab - 1)
    for at in (1500, 3000, 4500):
        x[at:at + 200] = x[100:300]
    return x.astype(np.int64)


TEXTS = {"strains": strains, "infinigram_like": infinigram_like}


def dcv_counts(before: dict) -> dict:
    after = counters()
    return {name[len(PREFIX):]: after[name] - before.get(name, 0)
            for name in after if name.startswith(PREFIX)}


def spied_build(x, impl, monkeypatch):
    """The suffix array of `x`, the DC-v counters it moved, and what spies
    on the recursion's `window_order`, `run_state` and `lemma1_order`
    saw: calls, calls, and rows handed over."""
    seen = {"window_order": 0, "run_state": 0, "lemma1": 0}

    def spy(name, fn, rows=False):
        def wrapped(*args, **kwargs):
            seen[name] += len(args[0]) if rows else 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(dcv_torch, fn.__name__, wrapped)

    spy("window_order", dcv_torch.window_order)
    spy("run_state", dcv_torch.run_state)
    spy("lemma1", dcv_torch.lemma1_order, rows=True)
    before = counters()
    sa = dcv_torch.suffix_array_torch(x, sort_impl=impl, device="cpu")
    return sa, dcv_counts(before), seen


@pytest.mark.parametrize("impl", ["radix", "kernel"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_counters_equal_what_spies_see(name, impl, monkeypatch):
    x = TEXTS[name]()
    sa, counts, seen = spied_build(x, impl, monkeypatch)
    np.testing.assert_array_equal(sa.numpy(), suffix_array_doubling(x))
    assert counts.get("levels", 0) == seen["window_order"] >= 1
    # `_resolve_ties` reads the runs once a level, then once a round
    assert counts.get("refine_rounds", 0) == \
        seen["run_state"] - seen["window_order"]
    assert counts.get("lemma1_rows", 0) == seen["lemma1"]
    if name == "strains":            # the mechanism this counts does run
        assert counts["refine_rounds"] >= 1 and counts["lemma1_rows"] >= 1


@pytest.mark.parametrize("impl", ["radix", "kernel"])
def test_counting_changes_no_output(impl, monkeypatch):
    x = strains()
    counted = dcv_torch.suffix_array_torch(x, sort_impl=impl, device="cpu")
    monkeypatch.setattr(dcv_torch, "count", lambda name, n=1: None)
    before = counters()
    uncounted = dcv_torch.suffix_array_torch(x, sort_impl=impl,
                                             device="cpu")
    assert not any(dcv_counts(before).values())
    assert counted.dtype == uncounted.dtype
    np.testing.assert_array_equal(counted.numpy(), uncounted.numpy())
