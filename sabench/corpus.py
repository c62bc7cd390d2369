"""Seeded corpora of documents, one general generator for every
configuration (the configuration file holds its parameters).

Token ids are Zipf-distributed over ``vocab`` ids (id k-1 has weight
k^-exponent). Document lengths are fixed by the configuration, either one
length for every document or the quantiles of a log-normal law scaled to
exactly ``tokens`` data tokens, so every seed has the same set of sizes in
another order. A share of the documents carries a passage copied from
another document, with passage lengths spread evenly over the stated
range, so long repeats drive the recursion as near-duplicates do.

The tokens are drawn on the device with a `torch.Generator` in a few large
calls; the documents reach the program as host arrays, the form a corpus
pipeline hands to `SuffixArrayIndex.from_docs`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Corpus:
    """`data` holds the documents back to back (int64, on the device) and
    `lengths` splits it (int64, on the device); `docs` is an object array
    of views of its copy on the host, one a document, in the same order."""

    data: torch.Tensor
    lengths: torch.Tensor
    docs: np.ndarray

    @property
    def n_docs(self) -> int:
        return len(self.docs)

    @property
    def tokens(self) -> int:
        return int(self.data.numel())


def doc_lengths(tokens: int, spec: dict) -> np.ndarray:
    """The documents' lengths before shuffling: int64, summing to
    `tokens`."""
    if spec["dist"] == "fixed":
        value = int(spec["value"])
        if tokens % value:
            raise ValueError(f"{tokens} tokens are not whole documents "
                             f"of {value}")
        return np.full(tokens // value, value, np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length law {spec['dist']!r}")
    n_docs = tokens // int(spec["mean"])
    sigma = float(spec["sigma"])
    q = (torch.arange(n_docs, dtype=torch.float64) + 0.5) / n_docs
    raw = torch.exp(torch.special.ndtri(q) * sigma).numpy()
    ends = np.rint(np.cumsum(raw) * (tokens / raw.sum())).astype(np.int64)
    ends[-1] = tokens
    lengths = np.diff(ends, prepend=0)
    if lengths.min() < 1:
        raise ValueError("the length law gives an empty document")
    return lengths


def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    weights = torch.arange(1, vocab + 1, dtype=torch.float64,
                           device=device).pow(-exponent)
    cdf = torch.cumsum(weights, 0)
    return cdf / cdf[-1]


def make_corpus(config: dict, seed: int, device) -> Corpus:
    """The configuration's corpus for `seed` (same seed, same corpus)."""
    spec = config["corpus"]
    tokens = int(config["tokens"])
    vocab = int(spec["vocab"])
    seed %= 2 ** 63
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    lengths_h = rng.permutation(doc_lengths(tokens, spec["doc_length"]))
    starts_h = np.cumsum(lengths_h) - lengths_h
    u = torch.rand(tokens, generator=gen, dtype=torch.float64, device=device)
    data = torch.searchsorted(zipf_cdf(vocab, float(spec["zipf_exponent"]),
                                       device), u)
    del u
    data.clamp_(max=vocab - 1)

    # copied passages: destinations without repeats, sources among the
    # documents long enough, read from the corpus before any copy
    n_docs = len(lengths_h)
    n_copy = int(round(float(spec["copy_share"]) * n_docs))
    if n_copy:
        lo, hi = spec["passage"]
        want = np.rint(np.linspace(lo, hi, n_copy)).astype(np.int64)
        dst = rng.permutation(n_docs)[:n_copy]
        plen = np.minimum(rng.permutation(want), lengths_h[dst])
        by_len = np.argsort(lengths_h, kind="stable")
        eligible = n_docs - np.searchsorted(lengths_h[by_len], plen)
        src = by_len[n_docs - 1 - np.floor(
            rng.random(n_copy) * eligible).astype(np.int64)]
        dst_off = np.floor(rng.random(n_copy) * (lengths_h[dst] - plen + 1))
        src_off = np.floor(rng.random(n_copy) * (lengths_h[src] - plen + 1))
        dst_at = torch.as_tensor(starts_h[dst] + dst_off.astype(np.int64),
                                 device=device)
        src_at = torch.as_tensor(starts_h[src] + src_off.astype(np.int64),
                                 device=device)
        plen_t = torch.as_tensor(plen, device=device)
        first = torch.cumsum(plen_t, 0) - plen_t
        step = torch.arange(int(plen.sum()), device=device) - \
            torch.repeat_interleave(first, plen_t)
        data[torch.repeat_interleave(dst_at, plen_t) + step] = \
            data[torch.repeat_interleave(src_at, plen_t) + step]

    data_h = data.cpu().numpy()
    docs = np.empty(n_docs, dtype=object)
    for i, (start, length) in enumerate(zip(starts_h.tolist(),
                                            lengths_h.tolist())):
        docs[i] = data_h[start:start + length]
    return Corpus(data=data, lengths=torch.as_tensor(lengths_h, device=device),
                  docs=docs)


def build_order(seed: int, k: int, n_docs: int) -> np.ndarray:
    """The order of the documents in the window's build k: a permutation
    drawn from the seed and k."""
    return np.random.default_rng([seed % (2 ** 63), k]).permutation(n_docs)

