"""Sharded extraction service with async admission (DESIGN.md §7).

Scaling the plan cache past one lock means exploiting what PR 2 set up:
cache keys are *stable sha256 content hashes* and plans are *immutable*.
Three layers build on that:

* :class:`ShardedPlanCache` — N independent :class:`PlanCache` shards
  behind a consistent-hash ring (:class:`repro_torch.distributed.
  sharding.HashRing`).  A key's 64-bit hex prefix routes it to one
  shard, so concurrent requests for different geometries contend on
  different locks; adding a shard remaps only ~1/N of the key space and
  migrates exactly those entries.
* :class:`ShardedExtractionService` — per-shard planning locks replace
  the single ``ExtractionService`` lock: a cold miss serializes only
  against cold misses *on the same shard*.  Gathers still run lock-free
  (plans are immutable) through the same shared union read as the
  single-lock service.  Replicas connected via :meth:`connect_peer`
  receive every cold plan over the pickled-plan wire format that the
  plan checker's CLI consumes (``{"plan", "n_elements"}`` plus the
  key), so one replica's planning work warms the whole fleet —
  verified on receipt (``repro_torch.analysis.plan_check``).
* :class:`AdmissionQueue` — async admission in front of
  ``submit_batch``: callers get a ``Future`` immediately, a worker
  drains the arrival window (every ``window_s`` or at ``max_batch``)
  and serves the whole window as one batch — duplicate geometries
  coalesce into one plan lookup and one slice of one shared union read
  *across callers*, not just within a single caller's batch.

The logic is the JAX package's ``serve/sharded.py`` unchanged.  On the
card the shared union read of every window and each plan's slice of it
are one ``gather_union_slices`` launch over a CUDA payload:
``device=None`` means the card (raises when there is none), and
``device="cpu"`` serves CPU tensors with the plain version.  The barrier-started thread swarms of
``tests/test_torch_sharded.py`` hold it to the JAX package's results.
"""

from __future__ import annotations

import pickle
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, fields, replace
from typing import Any, Iterable, Sequence

from repro_torch.core import PolytopeExtractor, Request
from repro_torch.core.datacube import Datacube
from repro_torch.core.delta_planner import DeltaPlanner
from repro_torch.core.index_tree import ExtractionPlan
from repro_torch.core.shapes import CANON_TOL
from repro_torch.distributed.sharding import HashRing
from repro_torch.serve.extraction import (CacheStats, NeighborhoodIndex,
                                          PlanCache, ServiceResult,
                                          merge_stats, shared_union_gather)


# ---------------------------------------------------------------------------
# Plan shipping wire format
# ---------------------------------------------------------------------------

def serialize_plan(key: str, plan: ExtractionPlan,
                   n_elements: int | None = None) -> bytes:
    """Pickle a plan in the envelope the plan checker's CLI consumes
    (``{"plan": ..., "n_elements": ...}``), plus the cache key so the
    receiving replica can install it without re-canonicalizing."""
    return pickle.dumps({"plan": plan, "n_elements": n_elements,
                         "key": key})


def deserialize_plan(blob: bytes, verify: bool = True,
                     ) -> tuple[str, ExtractionPlan]:
    """Inverse of :func:`serialize_plan`; with ``verify`` the plan is
    machine-checked against its invariants before it can warm a cache —
    a corrupt or truncated shipment raises instead of installing."""
    obj = pickle.loads(blob)
    key, plan = obj["key"], obj["plan"]
    if verify:
        from repro_torch.analysis.plan_check import verify_plan

        verify_plan(plan, n_elements=obj.get("n_elements"))
    return key, plan


# ---------------------------------------------------------------------------
# Consistent-hash-sharded plan cache
# ---------------------------------------------------------------------------

class ShardedPlanCache:
    """N :class:`PlanCache` shards behind a :class:`HashRing`.

    Reads/writes route by canonical-hash prefix and synchronize only on
    the owning shard's internal lock.  Topology changes
    (:meth:`add_shard`, :meth:`remove_shard`) are admin-plane: they
    serialize on ``_admin_lock`` and swap ring state atomically, so
    routing never observes a half-built ring.  The shard map itself is
    only ever grown via ``dict.update`` (atomic under the GIL) *before*
    the ring can route to the new shard.
    """

    def __init__(self, shards: Iterable[str] | int = 4,
                 capacity_per_shard: int = 1024, replicas: int = 64):
        if isinstance(shards, int):
            shards = tuple(f"shard{i}" for i in range(shards))
        names = tuple(shards)
        if not names:
            raise ValueError("need at least one shard")
        self.capacity_per_shard = capacity_per_shard
        self._caches: dict[str, PlanCache] = {
            n: PlanCache(capacity_per_shard) for n in names}
        # Per-shard neighborhood indices, routed by *signature* hash —
        # drifted variants of one shape share a signature, so they all
        # route to the same shard's index regardless of which shards
        # their exact keys live on (parent plans fetch globally via
        # :meth:`peek`).
        self._hoods: dict[str, NeighborhoodIndex] = {
            n: NeighborhoodIndex(capacity_per_shard) for n in names}
        self.ring = HashRing(names, replicas=replicas)
        self._admin_lock = threading.Lock()

    # -- routing -----------------------------------------------------------
    @property
    def shard_names(self) -> tuple[str, ...]:
        return self.ring.nodes

    def entry_of(self, key: str) -> tuple[str, PlanCache]:
        """Route once: ``(owning shard name, its cache)``.  One route per
        operation, so a concurrent rebalance can't split an operation
        across two different owners."""
        shard = self.ring.route(key)
        return shard, self._caches[shard]

    # -- the PlanCache surface, sharded ------------------------------------
    def get(self, key: str) -> ExtractionPlan | None:
        return self.entry_of(key)[1].get(key)

    def peek(self, key: str) -> ExtractionPlan | None:
        """Uncounted cross-shard plan fetch (delta-planner parents)."""
        return self.entry_of(key)[1].peek(key)

    def hood_of(self, sig: str) -> NeighborhoodIndex:
        """Neighborhood index owning signature ``sig`` (consistent
        routing: every drifted variant of a shape resolves here)."""
        return self._hoods[self.ring.route(sig)]

    def put(self, key: str, plan: ExtractionPlan) -> None:
        self.entry_of(key)[1].put(key, plan)

    def __contains__(self, key: str) -> bool:
        return key in self.entry_of(key)[1]

    def __len__(self) -> int:
        return sum(len(c) for c in self._caches.values())

    def keys(self) -> list[str]:
        return [k for c in self._caches.values() for k in c.keys()]

    def shard_sizes(self) -> dict[str, int]:
        return {n: len(self._caches[n]) for n in self.ring.nodes}

    @property
    def stats(self) -> CacheStats:
        """Fleet-wide counters: field-wise sum of per-shard snapshots."""
        return merge_stats(c.snapshot() for c in self._caches.values())

    # -- topology ----------------------------------------------------------
    def add_shard(self, name: str) -> int:
        """Add a shard and migrate the ~1/N entries it now owns.

        Returns the number of migrated entries.  Entries planned
        concurrently with the migration may land on the old owner and be
        re-planned once on their new shard — plans are immutable and
        content-addressed, so a duplicate plan is benign.
        """
        with self._admin_lock:
            if name in self._caches:
                raise ValueError(f"shard {name!r} already exists")
            # publish the cache before the ring can route to it
            self._caches.update({name: PlanCache(self.capacity_per_shard)})
            self._hoods.update(
                {name: NeighborhoodIndex(self.capacity_per_shard)})
            self.ring.add_node(name)
            return self._migrate()

    def remove_shard(self, name: str) -> int:
        """Drain a shard: its entries migrate to their new owners.

        The drained shard's *counters* fold into a surviving shard
        before the cache object is dropped, so fleet-wide ``stats``
        conserve across topology changes (including the ``migrations``
        the drain itself just counted)."""
        with self._admin_lock:
            if name not in self._caches or len(self._caches) == 1:
                raise ValueError(f"cannot remove shard {name!r}")
            self.ring.remove_node(name)
            moved = self._migrate(drain=name)
            drained = self._caches.pop(name).snapshot()
            self._hoods.pop(name)
            survivor = self._caches[self.ring.nodes[0]]
            survivor.record(**{f.name: getattr(drained, f.name)
                               for f in fields(CacheStats)})
            return moved

    def _migrate(self, drain: str | None = None) -> int:
        """Move every entry whose ring owner changed (caller holds the
        admin mutex; per-entry moves use the shard caches' own locks).
        ``PlanCache.pop`` counts each move in the source shard's
        ``stats.migrations``; neighborhood entries reroute by signature
        alongside (uncounted — they index plans, they aren't plans)."""
        moved = 0
        for old_name in list(self._caches):
            cache = self._caches[old_name]
            for key in cache.keys():
                owner = self.ring.route(key)
                if owner == old_name and old_name != drain:
                    continue
                plan = cache.pop(key)
                if plan is not None:   # racing eviction — nothing to move
                    self._caches[owner].put(key, plan)
                    moved += 1
        for old_name in list(self._hoods):
            hood = self._hoods[old_name]
            for sig in hood.signatures():
                owner = self.ring.route(sig)
                if owner == old_name and old_name != drain:
                    continue
                entries = hood.pop_signature(sig)
                if entries:
                    self._hoods[owner].install(sig, entries)
        return moved


# ---------------------------------------------------------------------------
# Sharded service
# ---------------------------------------------------------------------------

class ShardedExtractionService:
    """``ExtractionService`` semantics with per-shard locking and
    cross-replica plan shipping.

    The single service lock is gone: plan lookups synchronize on the
    owning shard's cache lock, cold planning serializes on a per-shard
    planning lock (so concurrent misses of the *same* geometry plan
    once, while misses on different shards plan in parallel), and
    gather accounting takes a dedicated I/O lock.  Gathers themselves
    run lock-free — plans are immutable.

    ``device=None`` means the card (raises when there is none): a tensor
    payload must lie there.  ``device="cpu"`` serves CPU tensors.
    """

    def __init__(self, datacube: Datacube, shards: Iterable[str] | int = 4,
                 capacity_per_shard: int = 1024, use_kernel: bool = False,
                 tol: float = CANON_TOL,
                 periods: dict[str, float] | None = None,
                 verify: bool = False, replicas: int = 64,
                 name: str = "replica0", delta: bool = True,
                 drift_steps: int = 64, device=None):
        self.datacube = datacube
        self.verify = verify
        self.name = name
        self.extractor = PolytopeExtractor(datacube, use_kernel=use_kernel,
                                           verify=verify, device=device)
        self.shards = ShardedPlanCache(shards, capacity_per_shard,
                                       replicas=replicas)
        # Same transparent-fallback contract as ExtractionService: an
        # exact-cache miss first tries a delta splice from the
        # signature-routed neighborhood before planning cold.
        self.delta_planner = None
        if delta:
            self.delta_planner = DeltaPlanner(
                datacube, slicer=self.extractor.slicer,
                max_steps=drift_steps)
        self.tol = tol
        self.periods = dict(periods) if periods is not None \
            else datacube.axis_periods()
        self._plan_locks: dict[str, threading.Lock] = {
            n: threading.Lock() for n in self.shards.shard_names}
        self._peers: list[ShardedExtractionService] = []
        self._io_lock = threading.Lock()
        self.io_stats = CacheStats()

    # -- stats -------------------------------------------------------------
    @property
    def stats(self) -> CacheStats:
        """Service-wide counters: shard snapshots + gather accounting."""
        with self._io_lock:
            io = replace(self.io_stats)
        return merge_stats([self.shards.stats, io])

    # -- planning ----------------------------------------------------------
    def plan(self, request: Request) -> tuple[ExtractionPlan, bool, str]:
        plan, cached, key, _ = self._plan_one(request)
        return plan, cached, key

    def _plan_one(self, request: Request,
                  key: str | None = None):
        if key is None:
            key = request.canonical_hash(self.tol, self.periods)
        shard, cache = self.shards.entry_of(key)
        # Uncounted membership probe first, so the counted lookup below
        # runs exactly once per request (a double-check get would score
        # every cold plan as two misses and skew the hit rate).
        if key in cache:
            plan = cache.get(key)
            if plan is not None:
                return plan, True, key, None
        lock = self._plan_locks.setdefault(shard, threading.Lock())
        with lock:
            plan = cache.get(key)   # counted; did a racing thread win?
            if plan is not None:
                return plan, True, key, None
            spliced = None
            if self.delta_planner is not None:
                spliced = self._try_delta(request, key, cache)
            if spliced is not None:
                plan, sstats = spliced
            else:
                t0 = time.perf_counter()
                plan, sstats = self.extractor.plan(request)
                cache.record(plan_time_s=time.perf_counter() - t0)
                cache.put(key, plan)
                self._index_neighbor(request, key, sstats)
        self._ship(key, plan)
        return plan, False, key, sstats

    def _try_delta(self, request: Request, key: str, cache: PlanCache):
        """Splice from a drifted neighbor (caller holds the shard's
        plan lock).  The signature routes to one shard's neighborhood;
        parent plans fetch cross-shard by their exact keys.  Returns
        ``(plan, stats)`` or ``None`` (→ plan cold)."""
        t0 = time.perf_counter()
        sig, anchor = request.shape_signature(self.tol)
        hood = self.shards.hood_of(sig)
        for entry in hood.candidates(sig):
            shifts = self.delta_planner.axis_shifts(entry.anchor, anchor)
            if shifts is None:
                continue
            parent = self.shards.peek(entry.key)
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
            cache.put(key, plan)
            hood.add(sig, key, anchor, request, stats)
            cache.record(delta_hits=1,
                         delta_time_s=time.perf_counter() - t0)
            return plan, stats
        cache.record(delta_misses=1)
        return None

    def _index_neighbor(self, request: Request, key: str,
                        stats) -> None:
        if self.delta_planner is None or stats is None:
            return
        sig, anchor = request.shape_signature(self.tol)
        self.shards.hood_of(sig).add(sig, key, anchor, request, stats)

    # -- batched serving ---------------------------------------------------
    def extract(self, request: Request,
                flat_data: Any | None = None) -> ServiceResult:
        return self.submit_batch([request], flat_data)[0]

    def submit_batch(self, requests: Sequence[Request],
                     flat_data: Any | None = None) -> list[ServiceResult]:
        """Batch semantics identical to ``ExtractionService.submit_batch``
        — dedupe by canonical hash, plan misses once, one shared union
        read — but with no global lock on the planning path."""
        results: list[ServiceResult] = []
        batch_plans: dict[str, ExtractionPlan] = {}
        for req in requests:
            key = req.canonical_hash(self.tol, self.periods)
            if key in batch_plans:
                self.shards.entry_of(key)[1].record(batch_dedup=1)
                results.append(ServiceResult(
                    request=req, key=key, plan=batch_plans[key],
                    cached=True))
                continue
            plan, cached, key, sstats = self._plan_one(req, key)
            batch_plans[key] = plan
            results.append(ServiceResult(
                request=req, key=key, plan=plan, cached=cached,
                stats=sstats))
        if flat_data is not None:
            self.extractor.check_payload(flat_data)
            requested, read, dt = shared_union_gather(
                self.datacube, results, batch_plans, flat_data,
                use_kernel=self.extractor.use_kernel, verify=self.verify)
            with self._io_lock:
                self.io_stats.bytes_requested += requested
                self.io_stats.bytes_read += read
                self.io_stats.gather_time_s += dt
        return results

    # -- topology ----------------------------------------------------------
    def add_shard(self, name: str) -> int:
        """Grow the ring; returns the number of migrated cache entries."""
        self._plan_locks.setdefault(name, threading.Lock())
        return self.shards.add_shard(name)

    # -- cross-replica plan shipping ---------------------------------------
    def connect_peer(self, peer: "ShardedExtractionService") -> None:
        """Subscribe ``peer`` to this replica's cold plans (one-way;
        call on both services for symmetric warming)."""
        if peer is self:
            raise ValueError("a replica cannot peer with itself")
        self._peers.append(peer)

    def _ship(self, key: str, plan: ExtractionPlan) -> None:
        if not self._peers:
            return
        blob = serialize_plan(key, plan,
                              n_elements=self.datacube.n_elements)
        shipped = 0
        for peer in tuple(self._peers):
            peer.receive_plan(blob)
            shipped += 1
        self.shards.entry_of(key)[1].record(plans_shipped=shipped)

    def receive_plan(self, blob: bytes) -> str:
        """Install a peer's shipped plan (verified when ``verify``);
        returns the installed cache key."""
        key, plan = deserialize_plan(blob, verify=self.verify)
        _, cache = self.shards.entry_of(key)
        cache.put(key, plan)
        cache.record(plans_received=1)
        return key


# ---------------------------------------------------------------------------
# Async admission
# ---------------------------------------------------------------------------

@dataclass
class AdmissionStats:
    """Arrival-window coalescing instrumentation."""

    submitted: int = 0      # requests accepted into the queue
    served: int = 0         # futures resolved
    windows: int = 0        # batches drained
    coalesced: int = 0      # duplicate geometries folded within windows
    window_max: int = 0     # largest window drained

    @property
    def coalescing_factor(self) -> float:
        """served / distinct-planned ≥ 1: cross-caller sharing per
        window (1.0 = no duplicate geometry ever coalesced)."""
        distinct = self.served - self.coalesced
        return self.served / distinct if distinct else 1.0


class AdmissionQueue:
    """Async admission in front of a service's ``submit_batch``.

    Callers :meth:`submit` a request and immediately get a ``Future``.
    A worker thread drains the pending window whenever ``window_s``
    elapses or ``max_batch`` requests accumulate, and serves the whole
    window as one batch — so identical geometries arriving from
    *different* callers within a window coalesce into one plan lookup
    and one slice of one shared union read.
    """

    def __init__(self, service: Any, flat_data: Any | None = None,
                 window_s: float = 0.002, max_batch: int = 64):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = service
        self.flat_data = flat_data
        self.window_s = window_s
        self.max_batch = max_batch
        self.stats = AdmissionStats()
        self._pending: list[tuple[Request, Future]] = []
        self._closed = False
        self._lock = threading.Condition()
        self._worker = threading.Thread(target=self._run,
                                        name="admission-worker",
                                        daemon=True)
        self._worker.start()

    # -- caller side -------------------------------------------------------
    def submit(self, request: Request) -> "Future[ServiceResult]":
        """Enqueue; the future resolves with the window's
        :class:`ServiceResult` for this request."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("AdmissionQueue is closed")
            self._pending.append((request, fut))
            self._lock.notify_all()
        return fut

    def extract(self, request: Request,
                timeout: float | None = None) -> ServiceResult:
        """Synchronous convenience: submit and wait."""
        return self.submit(request).result(timeout)

    def snapshot(self) -> AdmissionStats:
        with self._lock:
            return replace(self.stats)

    # -- worker side -------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed and not self._pending:
                    return
                # Window open: wait out the arrival window (or fill up),
                # then drain everything that accumulated.
                deadline = time.monotonic() + self.window_s
                while (len(self._pending) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(remaining)
                window = self._pending
                self._pending = []
                self.stats.submitted += len(window)
                self.stats.windows += 1
                self.stats.window_max = max(self.stats.window_max,
                                            len(window))
            self._serve_window(window)

    def _serve_window(self,
                      window: list[tuple[Request, Future]]) -> None:
        """Serve one drained window as a single batch (no admission lock
        held: planning/gather contend only on the service's locks)."""
        requests = [req for req, _ in window]
        try:
            results = self.service.submit_batch(requests, self.flat_data)
        except BaseException as e:
            for _, fut in window:
                fut.set_exception(e)
            return
        distinct = len({r.key for r in results})
        with self._lock:
            self.stats.served += len(results)
            self.stats.coalesced += len(results) - distinct
        for (_, fut), res in zip(window, results):
            fut.set_result(res)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float | None = 10.0) -> None:
        """Drain remaining requests, then stop the worker."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout)

    def __enter__(self) -> "AdmissionQueue":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
