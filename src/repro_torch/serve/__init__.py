# Extraction serving: plan cache + batched service with shared union
# reads, and the sharded service with async admission (sharded.py).
# LM serving: the paged KV pager (kv_cache.py) and the continuous-
# batching engine over it (engine.py), imported from their modules.
from .extraction import (CacheStats, ExtractionService, NeighborhoodIndex,
                         PlanCache, ServiceResult, merge_stats,
                         shared_union_gather)
from .sharded import (AdmissionQueue, AdmissionStats,
                      ShardedExtractionService, ShardedPlanCache,
                      deserialize_plan, serialize_plan)

__all__ = ["CacheStats", "ExtractionService", "NeighborhoodIndex",
           "PlanCache", "ServiceResult", "merge_stats",
           "shared_union_gather", "AdmissionQueue", "AdmissionStats",
           "ShardedExtractionService", "ShardedPlanCache",
           "deserialize_plan", "serialize_plan"]
