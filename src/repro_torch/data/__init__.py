"""The training data plane of the port (`repro_torch.data.pipeline`)."""
from .pipeline import (GATE_POLICIES, ContaminationGate, MemorizationProbe,
                       PipelineConfig, PlaneReport, ShardStats,
                       StreamingDedup, TokenPipeline, TrainingDataPlane,
                       synthetic_corpus, synthetic_doc_shards)

__all__ = [
    "GATE_POLICIES", "ContaminationGate", "MemorizationProbe",
    "PipelineConfig", "PlaneReport", "ShardStats", "StreamingDedup",
    "TokenPipeline", "TrainingDataPlane", "synthetic_corpus",
    "synthetic_doc_shards",
]
