"""Extraction service: plan caching + batched request serving (DESIGN.md §4).

Production request streams against a datacube are highly repetitive —
the same country crop every forecast cycle, the same recsys region every
step, the same flight corridor for every flight on a route.  Re-running
Algorithm 1 per request makes *planning*, not I/O, the bottleneck at
scale.  This layer:

* keys every request by its canonical content hash
  (``Request.canonical_hash``) so permuted-but-equivalent requests
  collide;
* serves :class:`~repro_torch.core.index_tree.ExtractionPlan` objects from a
  bounded LRU (:class:`PlanCache`) with hit/miss/eviction counters
  exposed like ``SliceStats``;
* dedupes concurrent requests inside a batch (plan once, share the
  plan object);
* executes all cache-missed gathers of a batch through one shared
  coalesced-run union read, so overlapping requests read each byte once.

Plans are immutable once built, so cache hits return the *same* plan
object — byte-identical offsets to the cold plan by construction.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, fields, replace
from typing import Any, Iterable, Sequence

import numpy as np

import torch

from repro_torch.core import PolytopeExtractor, Request, gather
from repro_torch.core.datacube import Datacube
from repro_torch.core.delta_planner import DeltaPlanner
from repro_torch.core.extractor import gather_offsets
from repro_torch.core.index_tree import ExtractionPlan, coalesce_runs
from repro_torch.core.shapes import CANON_TOL
from repro_torch.core.slicer import SliceStats


@dataclass
class CacheStats:
    """Plan-cache instrumentation (the serving analogue of SliceStats)."""

    hits: int = 0                   # plan served from the LRU
    misses: int = 0                 # plan built by Algorithm 1
    evictions: int = 0              # plans dropped at capacity
    batch_dedup: int = 0            # duplicate requests inside one batch
    plan_time_s: float = 0.0        # cumulative cold-planning walltime
    gather_time_s: float = 0.0      # cumulative shared-gather walltime
    bytes_requested: int = 0        # sum over served requests
    bytes_read: int = 0             # union reads actually issued
    plans_shipped: int = 0          # cold plans shipped to peer replicas
    plans_received: int = 0         # peer plans installed locally
    migrations: int = 0             # entries popped for shard rebalance
    delta_hits: int = 0             # misses served by plan splicing
    delta_misses: int = 0           # misses with no splicable neighbor
    delta_time_s: float = 0.0       # cumulative splice walltime

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    @property
    def sharing_factor(self) -> float:
        """requested/read ≥ 1: how much the batch union read saved.

        Edge cases are explicit: nothing requested *and* nothing read
        (only empty plans in the batch) shares nothing and reports the
        neutral 1.0; bytes requested with **zero** bytes read is
        infinite sharing (``inf``), not 1.0 — returning 1.0 here would
        silently under/over-report savings on empty-gather batches
        (pinned by the regression test in tests/test_plan_cache.py).
        """
        if self.bytes_read:
            return self.bytes_requested / self.bytes_read
        return float("inf") if self.bytes_requested else 1.0


def merge_stats(parts: Iterable[CacheStats]) -> CacheStats:
    """Field-wise sum of :class:`CacheStats` (derived rates recompute
    from the summed counters) — shard aggregation for the sharded cache."""
    out = CacheStats()
    for s in parts:
        for f in fields(CacheStats):
            setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
    return out


class PlanCache:
    """Bounded LRU of ``canonical_hash → ExtractionPlan``.

    Thread-safe: an internal lock serializes every OrderedDict access.
    ``keys()``/``__contains__`` racing a concurrent ``put`` eviction
    would otherwise iterate the dict mid-mutation — the unsynchronized
    read the lock-discipline fixture in ``tests/test_analysis.py`` pins
    as a regression.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._od: OrderedDict[str, ExtractionPlan] = OrderedDict()
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._od

    def get(self, key: str) -> ExtractionPlan | None:
        with self._lock:
            plan = self._od.get(key)
            if plan is None:
                self.stats.misses += 1
                return None
            self._od.move_to_end(key)
            self.stats.hits += 1
            return plan

    def put(self, key: str, plan: ExtractionPlan) -> None:
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
            self._od[key] = plan
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.stats.evictions += 1

    def peek(self, key: str) -> ExtractionPlan | None:
        """Uncounted, non-mutating lookup: the delta planner fetching a
        *parent* plan is not a request-path cache lookup, so it must not
        perturb the hit/miss counters (``lookups == hits + misses``
        stays tied to served requests) nor the LRU order (eviction
        reflects what users requested, not which parents were spliced
        from — the freshly spliced child is put at MRU anyway)."""
        with self._lock:
            return self._od.get(key)

    def pop(self, key: str) -> ExtractionPlan | None:
        """Remove and return ``key``'s plan (shard-rebalance migration).

        Counts ``stats.migrations`` when an entry was actually removed —
        without the counter, rebalance mutated the cache invisibly and
        the stats-conservation invariant in
        tests/test_serve_concurrent.py silently ignored migrated
        entries."""
        with self._lock:
            plan = self._od.pop(key, None)
            if plan is not None:
                self.stats.migrations += 1
            return plan

    def keys(self) -> list[str]:
        """LRU → MRU order (eviction order is the front)."""
        with self._lock:
            return list(self._od)

    def record(self, **deltas: float) -> None:
        """Atomically bump :class:`CacheStats` counters by name
        (``record(plan_time_s=dt, batch_dedup=1)``)."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self.stats, name, getattr(self.stats, name) + d)

    def snapshot(self) -> CacheStats:
        """Consistent copy of the counters (safe to aggregate lock-free)."""
        with self._lock:
            return replace(self.stats)


@dataclass
class NeighborEntry:
    """One remembered request under a shape signature: where its plan
    lives (exact cache key), its per-axis anchor, and what it asked for
    (the delta planner re-slices changed leading slabs against it)."""

    key: str
    anchor: dict[str, float]
    request: Request
    stats: SliceStats


class NeighborhoodIndex:
    """Bounded two-level LRU: ``shape signature → recent requests``.

    The exact-match LRU misses every *drifted* repeat of a request; this
    index keys on the translation-invariant signature
    (``Request.shape_signature``) so a drifted request finds its parent
    plan, with the anchor delta left for the delta planner to apply.
    ``per_signature`` bounds the anchors remembered per shape; candidates
    come back MRU-first so the nearest parent is tried first.  The bound
    must absorb *interleaved* chains: congruent shapes at incompatible
    anchors (e.g. same-size boxes at different latitudes on the
    non-uniform Gaussian axis) share a signature, and a Zipf-skewed hot
    chain can flush a colder chain's parent out of too small a window.

    Thread-safe behind its own lock — entries are immutable once added.
    """

    def __init__(self, capacity: int = 1024, per_signature: int = 32):
        if capacity < 1 or per_signature < 1:
            raise ValueError("capacity and per_signature must be >= 1")
        self.capacity = capacity
        self.per_signature = per_signature
        self._od: OrderedDict[str, OrderedDict[str, NeighborEntry]] = \
            OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(inner) for inner in self._od.values())

    def add(self, sig: str, key: str, anchor: dict[str, float],
            request: Request, stats: SliceStats) -> None:
        with self._lock:
            inner = self._od.get(sig)
            if inner is None:
                inner = OrderedDict()
                self._od[sig] = inner
            else:
                self._od.move_to_end(sig)
            if key in inner:
                inner.move_to_end(key)
            inner[key] = NeighborEntry(key=key, anchor=anchor,
                                       request=request, stats=stats)
            while len(inner) > self.per_signature:
                inner.popitem(last=False)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)

    def candidates(self, sig: str) -> list[NeighborEntry]:
        """Entries under ``sig``, most-recently-added first."""
        with self._lock:
            inner = self._od.get(sig)
            if inner is None:
                return []
            self._od.move_to_end(sig)
            return list(reversed(inner.values()))

    # -- sharded-migration surface ---------------------------------------
    def signatures(self) -> list[str]:
        with self._lock:
            return list(self._od)

    def pop_signature(self, sig: str
                      ) -> "OrderedDict[str, NeighborEntry] | None":
        with self._lock:
            return self._od.pop(sig, None)

    def install(self, sig: str,
                entries: "OrderedDict[str, NeighborEntry]") -> None:
        with self._lock:
            inner = self._od.setdefault(sig, OrderedDict())
            inner.update(entries)
            while len(inner) > self.per_signature:
                inner.popitem(last=False)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)


@dataclass
class ServiceResult:
    """One served request: its plan, optional gathered values, and how
    the plan was obtained (``stats`` is None unless planned cold)."""

    request: Request
    key: str
    plan: ExtractionPlan
    cached: bool
    values: Any | None = None
    stats: SliceStats | None = None


class ExtractionService:
    """Many concurrent polytope requests → deduped, cached, batched
    extraction over one datacube.

    Thread-safe: the pipeline prefetcher calls :meth:`submit_batch` from
    its worker thread while launchers may probe stats from the main
    thread.

    ``device=None`` means the card (raises when there is none): a tensor
    payload must lie there, and the union read runs the ``gather_rows``
    kernel.  ``device="cpu"`` serves CPU tensors with the plain version.
    """

    def __init__(self, datacube: Datacube, capacity: int = 1024,
                 use_kernel: bool = False, tol: float = CANON_TOL,
                 periods: dict[str, float] | None = None,
                 verify: bool = False, delta: bool = True,
                 drift_steps: int = 64, device=None):
        self.datacube = datacube
        # verify=True machine-checks every cold plan AND every shared
        # union plan against the invariants in repro_torch.analysis.plan_check
        # (DESIGN.md §6) — the serving-layer switch for the paper's
        # byte-exactness contract.
        self.verify = verify
        self.extractor = PolytopeExtractor(datacube, use_kernel=use_kernel,
                                           verify=verify, device=device)
        self.cache = PlanCache(capacity)
        self.tol = tol
        # Cyclic-axis periods fold into the cache key: seam-straddling
        # requests shifted by whole periods hash identically, so the
        # plan cache hits across the seam (DESIGN.md §2.5).
        self.periods = dict(periods) if periods is not None \
            else datacube.axis_periods()
        # delta=True routes exact-cache misses through the neighborhood
        # index + delta planner (DESIGN.md §8) before falling back to a
        # cold Algorithm-1 run; ineligible drifts fall through
        # transparently, same opt-out contract as the device planner.
        self.delta_planner = None
        self.neighborhood = None
        if delta:
            self.delta_planner = DeltaPlanner(
                datacube, slicer=self.extractor.slicer,
                max_steps=drift_steps)
            self.neighborhood = NeighborhoodIndex(capacity)
        self._lock = threading.Lock()

    @property
    def stats(self) -> CacheStats:
        with self._lock:
            return self.cache.stats

    # -- single request ----------------------------------------------------
    def plan(self, request: Request) -> tuple[ExtractionPlan, bool, str]:
        """Plan one request through the cache.

        Returns ``(plan, cached, key)``; a hit returns the exact plan
        object built on the cold miss.
        """
        key = request.canonical_hash(self.tol, self.periods)
        with self._lock:
            plan = self.cache.get(key)
            if plan is not None:
                return plan, True, key
            plan, _ = self._plan_miss(request, key)
            return plan, False, key

    def _plan_miss(self, request: Request,
                   key: str) -> tuple[ExtractionPlan, SliceStats]:
        """Serve an exact-cache miss (caller holds ``self._lock``):
        try a delta splice from a drifted neighbor first, cold-plan
        otherwise; either way install the plan and index the request's
        signature for future drifts."""
        if self.delta_planner is not None:
            out = self._try_delta(request, key)
            if out is not None:
                return out
        t0 = time.perf_counter()
        plan, stats = self.extractor.plan(request)
        dt = time.perf_counter() - t0
        self.cache.stats.plan_time_s += dt  # unlocked-ok: caller holds _lock
        self.cache.put(key, plan)           # unlocked-ok: caller holds _lock
        if self.neighborhood is not None and stats is not None:
            sig, anchor = request.shape_signature(self.tol)
            self.neighborhood.add(sig, key, anchor, request, stats)
        return plan, stats

    def _try_delta(self, request: Request, key: str
                   ) -> "tuple[ExtractionPlan, SliceStats] | None":
        """Resolve the request's signature in the neighborhood index and
        splice from the nearest parent whose drift is eligible.  Spliced
        plans verify (when ``self.verify``), install under the exact
        key, and re-index — so a drift *chain* keeps splicing from its
        latest member instead of walking back to the origin."""
        t0 = time.perf_counter()
        sig, anchor = request.shape_signature(self.tol)
        for entry in self.neighborhood.candidates(sig):
            shifts = self.delta_planner.axis_shifts(entry.anchor, anchor)
            if shifts is None:
                continue
            parent = self.cache.peek(entry.key)  # unlocked-ok: caller holds _lock
            if parent is None:
                continue   # parent evicted under the index entry
            out = self.delta_planner.splice(request, entry.request,
                                            parent, entry.stats, shifts)
            if out is None:
                continue
            plan, stats = out
            if self.verify:
                from repro_torch.analysis.plan_check import verify_plan

                verify_plan(plan, datacube=self.datacube, stats=stats)
            self.cache.put(key, plan)  # unlocked-ok: caller holds _lock
            self.neighborhood.add(sig, key, anchor, request, stats)
            dt = time.perf_counter() - t0
            self.cache.stats.delta_hits += 1  # unlocked-ok: caller holds _lock
            self.cache.stats.delta_time_s += dt  # unlocked-ok: caller holds _lock
            return plan, stats
        self.cache.stats.delta_misses += 1  # unlocked-ok: caller holds _lock
        return None

    def extract(self, request: Request,
                flat_data: Any | None = None) -> ServiceResult:
        return self.submit_batch([request], flat_data)[0]

    # -- batched serving -----------------------------------------------------
    def submit_batch(self, requests: Sequence[Request],
                     flat_data: Any | None = None) -> list[ServiceResult]:
        """Serve a batch of concurrent requests.

        Requests are deduped by canonical hash (one plan per distinct
        geometry), missed plans run Algorithm 1 once, and — when
        ``flat_data`` is given — all distinct plans are gathered through
        a single coalesced union read shared across the batch.
        """
        keys = [r.canonical_hash(self.tol, self.periods) for r in requests]
        results: list[ServiceResult] = []
        batch_plans: dict[str, ExtractionPlan] = {}

        with self._lock:
            for req, key in zip(requests, keys):
                if key in batch_plans:
                    # same geometry earlier in this batch — share it
                    self.cache.stats.batch_dedup += 1
                    results.append(ServiceResult(
                        request=req, key=key, plan=batch_plans[key],
                        cached=True))
                    continue
                plan = self.cache.get(key)
                stats = None
                cached = plan is not None
                if plan is None:
                    plan, stats = self._plan_miss(req, key)
                batch_plans[key] = plan
                results.append(ServiceResult(
                    request=req, key=key, plan=plan, cached=cached,
                    stats=stats))

        # Gather outside the lock: plans are immutable and the results
        # are local, so concurrent callers only contend on the (short)
        # planning section, not on the batch I/O.  All _lock-protected state
        # (the cache) is only touched inside `with self._lock` blocks —
        # _gather_batch's stats updates re-enter the lock below.
        if flat_data is not None:
            self._gather_batch(results, batch_plans, flat_data)
        return results

    def _gather_batch(self, results: list[ServiceResult],
                      batch_plans: dict[str, ExtractionPlan],
                      flat_data: Any) -> None:
        """One union read for the whole batch, then slice each request's
        values out of the shared buffer (coalesced-run sharing)."""
        self.extractor.check_payload(flat_data)
        requested, read, dt = shared_union_gather(
            self.datacube, results, batch_plans, flat_data,
            use_kernel=self.extractor.use_kernel, verify=self.verify)
        with self._lock:
            self.cache.stats.bytes_requested += requested
            self.cache.stats.bytes_read += read
            self.cache.stats.gather_time_s += dt


def shared_union_gather(datacube: Datacube,
                        results: list[ServiceResult],
                        batch_plans: dict[str, ExtractionPlan],
                        flat_data: Any,
                        use_kernel: bool = False,
                        verify: bool = False) -> tuple[int, int, float]:
    """Execute one coalesced union read for ``batch_plans`` and slice each
    result's values out of the shared buffer.

    Fills ``res.values`` in place and returns
    ``(bytes_requested, bytes_read, gather_time_s)`` so the caller can
    fold the accounting into its own stats under its own lock.  Shared
    between :class:`ExtractionService` and the sharded service — both
    funnel a window's distinct plans through exactly one gather.
    """
    def empty():
        if isinstance(flat_data, torch.Tensor):
            return flat_data.new_empty((0,))
        return np.empty(0, datacube.dtype)

    nonempty = {k: p for k, p in batch_plans.items() if p.n_points}
    if not nonempty:
        for res in results:
            res.values = empty()
        return 0, 0, 0.0
    t0 = time.perf_counter()
    union = np.unique(np.concatenate(
        [p.offsets for p in nonempty.values()]))
    starts, lengths = coalesce_runs(union)
    union_plan = ExtractionPlan(
        offsets=union, run_starts=starts, run_lengths=lengths,
        coords={}, itemsize=datacube.dtype.itemsize)
    if verify:
        from repro_torch.analysis.plan_check import verify_plan

        verify_plan(union_plan, datacube=datacube)
    buf = gather(flat_data, union_plan, use_kernel=use_kernel)
    per_key: dict[str, Any] = {}
    for key, plan in nonempty.items():
        idx = np.searchsorted(union, plan.offsets)
        per_key[key] = gather_offsets(buf, idx)
    requested = 0
    for res in results:
        if res.plan.n_points:
            res.values = per_key[res.key]
        else:
            res.values = empty()
        requested += res.plan.nbytes
    return requested, union_plan.nbytes, time.perf_counter() - t0
