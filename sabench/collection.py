"""Seeded genome collections: many strains of one species, as the
Pizza&Chili repetitive corpus's `cere` holds (the configuration file
holds the parameters).

One base sequence is drawn i.i.d. over the four bases (ids 0-3 for A, C,
G, T) with the stated GC share. Each strain is the base with independent
substitutions at ``substitution_rate`` a site, each to one of the other
three bases with equal chance: a star phylogeny, no indels and no repeat
families. Every strain has the base's length, ``doc_length``.

The bases are drawn on the device with a `torch.Generator` in a few large
calls; the strains reach the program as host arrays, the form a genome
pipeline hands to `SuffixArrayIndex.from_docs`.
"""
from __future__ import annotations

import numpy as np
import torch

from sabench.corpus import Corpus

#: ids of A, C, G and T
BASES = 4


def base_cdf(gc_share: float, device) -> torch.Tensor:
    """The cumulative law of A, C, G, T: C and G share `gc_share`, A and T
    the rest."""
    at, gc = (1.0 - gc_share) / 2, gc_share / 2
    return torch.tensor([at, at + gc, at + 2 * gc, 1.0], dtype=torch.float64,
                        device=device)


def make_collection(config: dict, seed: int, device) -> Corpus:
    """The configuration's collection for `seed` (same seed, same
    collection): `strains` documents of `doc_length` bases each."""
    spec = config["collection"]
    strains, length = int(config["strains"]), int(config["doc_length"])
    rate = float(spec["substitution_rate"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)

    u = torch.rand(length, generator=gen, dtype=torch.float64, device=device)
    base = torch.searchsorted(base_cdf(float(spec["gc_share"]), device), u,
                              right=True).clamp_(max=BASES - 1)
    del u
    hit = torch.rand((strains, length), generator=gen, device=device) < rate
    shift = torch.randint(1, BASES, (strains, length), generator=gen,
                          device=device)
    data = ((base + shift * hit) % BASES).reshape(-1)
    del hit, shift

    data_h = data.cpu().numpy()
    docs = np.empty(strains, dtype=object)
    for i in range(strains):
        docs[i] = data_h[i * length:(i + 1) * length]
    lengths = torch.full((strains,), length, dtype=torch.int64, device=device)
    return Corpus(data=data, lengths=lengths, docs=docs)
