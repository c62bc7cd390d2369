"""The port's facade: `build_suffix_array`, `SAOptions`, the backend
registry, `SuffixArrayIndex` and the batched query engine."""
from .build import build_suffix_array, builder_cache_stats, clear_builder_cache
from .index import (NgramStats, SuffixArrayIndex, encode_docs,
                    index_from_numpy_state, longest_match_len)
from .options import SAOptions
from .query import QueryBatch, batch_ranges, pow2_bucket, stage_batch
from .registry import get_backend, register_backend, registered_backends

__all__ = [
    "NgramStats", "QueryBatch", "SAOptions", "SuffixArrayIndex",
    "batch_ranges", "build_suffix_array", "builder_cache_stats",
    "clear_builder_cache", "encode_docs", "get_backend",
    "index_from_numpy_state", "longest_match_len", "pow2_bucket",
    "register_backend", "registered_backends", "stage_batch",
]
