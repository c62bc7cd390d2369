"""The key families that the radix pass counter is held to, in one place:
the CPU parity tests (`test_torch_radix.py`), the card tests
(`test_torch_gpu.py`) and `chip_smoke.py` phase 2 all draw from here.
numpy only, so it loads where JAX is not installed."""
import numpy as np

#: random 63-bit keys, one constant key, nine keys in ten equal, and 45-bit
#: keys (the level-0 window word's width, whose top pass, shift 40, has 32
#: digits).
PASS_KINDS = ("random", "constant", "skewed", "top45")


def pass_keys(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """int64[n] non-negative keys of family `kind`, drawn from `rng`."""
    if kind == "random":
        keys = rng.integers(0, 2 ** 63, n)
    elif kind == "constant":
        keys = np.full(n, 0x0123456789ABCDE)
    elif kind == "skewed":
        keys = np.where(rng.random(n) < 0.9, 0x5A5A5A5A5A5A5A,
                        rng.integers(0, 2 ** 63, n))
    elif kind == "top45":
        keys = rng.integers(0, 2 ** 45, n)
    else:
        raise ValueError(f"unknown key family {kind!r}")
    return keys.astype(np.int64)
