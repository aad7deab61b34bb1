# Extraction serving: plan cache + batched service with shared union reads.
from .extraction import (CacheStats, ExtractionService, NeighborhoodIndex,
                         PlanCache, ServiceResult, merge_stats,
                         shared_union_gather)

__all__ = ["CacheStats", "ExtractionService", "NeighborhoodIndex",
           "PlanCache", "ServiceResult", "merge_stats",
           "shared_union_gather"]
