"""repro_torch.sparse — sampled-position suffix-array indexing.

The port of `repro.sparse`. A sparse suffix array stores the suffix order
of every ``sample_rate``-th position only, so the index's SA is s× smaller
than the dense one, with exact answers for every pattern of length ≥ s.

* `construct` — `build_sparse_suffix_array`: a packed-word head sort and
  stride-doubling tie rounds, each a `radix_argsort` on the device;
* `query` — a per-alignment double binary search on the device, then a
  vectorised head verification on the host;
* `index` — `SparseSuffixArrayIndex`; patterns shorter than the rate
  raise `PatternTooShortError`.

Select it through the facade: `SAOptions(sample_rate=s)` with ``s > 1``
makes `SuffixArrayIndex.build` / `.from_docs` build a sparse index.
"""
from .construct import build_sparse_suffix_array, sparse_lcp
from .index import PatternTooShortError, SparseSuffixArrayIndex

__all__ = [
    "PatternTooShortError",
    "SparseSuffixArrayIndex",
    "build_sparse_suffix_array",
    "sparse_lcp",
]
