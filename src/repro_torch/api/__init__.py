"""The port's facade: `build_suffix_array`, `SAOptions`, the backend
registry, `SuffixArrayIndex` and the batched query engine, `QuerySession`,
the segmented index (`SegmentedIndex`) and persistence (`IndexStore`,
`SegmentedIndexStore`)."""
from .build import build_suffix_array
from .index import (NgramStats, SuffixArrayIndex, encode_docs,
                    index_from_numpy_state, longest_match_len)
from .options import SAOptions
from .query import (QueryBatch, QuerySession, StagedBatch, batch_ranges,
                    clear_query_cache, pow2_bucket, query_cache_stats,
                    stage_batch)
from .registry import get_backend, register_backend, registered_backends
from .segments import Segment, SegmentedIndex
from .store import (IndexStore, SegmentedIndexStore, StaleIndexError,
                    corpus_fingerprint, load_index, save_index)

__all__ = [
    "IndexStore", "NgramStats", "QueryBatch", "QuerySession", "SAOptions",
    "Segment", "SegmentedIndex", "SegmentedIndexStore", "StagedBatch",
    "StaleIndexError", "SuffixArrayIndex", "batch_ranges",
    "build_suffix_array", "clear_query_cache", "corpus_fingerprint",
    "encode_docs", "get_backend", "index_from_numpy_state", "load_index", "longest_match_len",
    "pow2_bucket", "query_cache_stats", "register_backend",
    "registered_backends", "save_index", "stage_batch",
]
