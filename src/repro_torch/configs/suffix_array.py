"""The paper's own workload: suffix-array construction and serving configs
(corpus size, backend, v schedule, serving knobs).

The port of `repro.configs.suffix_array`, with its construction, serving
and data-plane fields and their defaults, less `cache` (see
`repro_torch.api.options`). `SAConfig` is a thin, frozen
launch-config wrapper; the executable plan is the
`repro_torch.api.SAOptions` it produces via `to_options()`, and the data
plane's `repro_torch.data.pipeline.PipelineConfig` comes from
`to_pipeline()`.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SAConfig:
    name: str = "suffix-array"
    n: int = 1 << 20            # corpus length (characters)
    backend: str = "auto"       # registry key, or "auto" (mesh → bsp,
                                # else torch)
    v0: int = 3
    schedule: str = "accelerated"   # or "fixed"
    base_threshold: int = 4096
    sort_impl: str = "auto"     # window sort of the torch backend
                                # (see SAOptions.sort_impl)
    pack_keys: bool = True
    sample_rate: int = 1        # >1: sparse sampled-position indexing
                                # (repro_torch.sparse) — index memory n/s,
                                # patterns shorter than this raise
                                # PatternTooShortError
    axis: str = "bsp"
    store_dir: str = ""         # IndexStore root for serving ("" = build
                                # in-process, never persist)
    query_batch: int = 64       # patterns per batched query tick
                                # (repro_torch.api.QuerySession batch_size)
    # ---- async serving tier (repro_torch.serve.SAServer) ----
    coalesce_max_wait_us: float = 500.0   # batch-window deadline: extra
                                # latency a lone request may pay to share
                                # a search with later arrivals
    queue_depth: int = 1024     # admission bound on queued requests
    overload_policy: str = "reject"  # "none" | "reject" | "shed"
                                # (repro_torch.serve.admission.POLICIES)
    arrival: str = "poisson"    # open-loop arrival process for serving/
                                # loadgen ("uniform"|"poisson"|"onoff")
    offered_qps: float = 2000.0  # open-loop offered load for launch/serve
    # ---- segmented incremental serving (repro_torch.api.SegmentedIndex) --
    segments: int = 0           # >0: serve a SegmentedIndex with this many
                                # segments (docs chunked evenly); 0 = the
                                # monolithic single-index path
    ingest: int = 0             # docs ingested through add_docs AFTER the
                                # initial build (exercises the incremental
                                # one-segment-per-ingest path in launch/serve)
    compact_fanin: int = 4      # size-tiered compaction trigger
                                # (SAOptions.compact_fanin)
    gc_hygiene: bool = True     # SAServer GC regime: pin gen-2 thresholds
                                # + freeze the index after warmup
    # ---- training data plane (repro_torch.data.pipeline) ----
    dedup_min_len: int = 48     # exact-substring dedup bar
                                # (= repro_torch.text.dedup.DEDUP_MIN_LEN)
    gate_min_len: int = 48      # train/eval contamination-gate gram length
    gate_policy: str = "reject"  # "reject" | "mask"
                                # (repro_torch.data.pipeline.GATE_POLICIES)
    shard_docs: int = 8         # documents per streamed ingest shard

    def to_pipeline(self, *, seq_len: int = 512, global_batch: int = 8,
                    dedup: bool = True, vocab=None, seed: int = 0):
        """A `repro_torch.data.pipeline.PipelineConfig` carrying this
        config's data-plane knobs (the SA plan rides along via
        `to_options`)."""
        from ..data.pipeline import PipelineConfig
        return PipelineConfig(
            seq_len=seq_len, global_batch=global_batch, dedup=dedup,
            dedup_min_len=self.dedup_min_len, seed=seed,
            options=self.to_options(), vocab=vocab,
            gate_min_len=self.gate_min_len, gate_policy=self.gate_policy)

    def to_options(self, *, mesh=None, counters=None, stats=None):
        """The `repro_torch.api.SAOptions` plan this config describes.
        Runtime objects (mesh, instrumentation sinks) are supplied here —
        they do not belong in a frozen launch config. A mesh selects the
        bsp backend (with ``backend="auto"``)."""
        from ..api import SAOptions
        return SAOptions(backend=self.backend, v0=self.v0,
                         schedule=self.schedule,
                         base_threshold=self.base_threshold,
                         sort_impl=self.sort_impl,
                         mesh=mesh, axis=self.axis,
                         pack_keys=self.pack_keys,
                         counters=counters, stats=stats,
                         compact_fanin=self.compact_fanin,
                         sample_rate=self.sample_rate)


CONFIG = SAConfig()
