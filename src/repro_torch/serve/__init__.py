"""Serving layer: bucketed batching, result caching, failure isolation, the
SLO control plane (admission control, deadlines, priority lanes, adaptive
degradation, fault injection), and live index mutation (the delta-segment
adapter and background compaction)."""

from repro_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    TenantQuota,
    TokenBucket,
)
from repro_torch.serve.buckets import Bucket, BucketLadder
from repro_torch.serve.cache import QueryResultCache
from repro_torch.serve.chaos import ChaosConfig, ChaosFault, ChaosInjector, ChaosRetriever
from repro_torch.serve.engine import RetrievalEngine, ServeStats
from repro_torch.serve.errors import (
    AdmissionRejected,
    DeadlineExceeded,
    EngineShutdown,
    ServeError,
)
from repro_torch.serve.mutable import (
    CompactionManager,
    MutableRetrievalResult,
    MutableRetrieverAdapter,
)
from repro_torch.serve.slo import SLOConfig, SLOController, default_degradation_ladder

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "Bucket",
    "BucketLadder",
    "ChaosConfig",
    "ChaosFault",
    "ChaosInjector",
    "ChaosRetriever",
    "CompactionManager",
    "DeadlineExceeded",
    "EngineShutdown",
    "MutableRetrievalResult",
    "MutableRetrieverAdapter",
    "QueryResultCache",
    "RetrievalEngine",
    "SLOConfig",
    "SLOController",
    "ServeError",
    "ServeStats",
    "TenantQuota",
    "TokenBucket",
    "default_degradation_ladder",
]
