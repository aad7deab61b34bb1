"""The port's sharded extraction service, hash ring and launcher == the
JAX package's, on CPU tensors.

Every stream runs through both packages: ``repro.serve.sharded`` over a
numpy payload and ``repro_torch.serve.sharded`` over the same payload as
a CPU tensor (``device="cpu"``: the plain PyTorch gather).  Served
values must equal fresh single-threaded extractions byte for byte, and
the counters must equal the JAX package's on the same stream.  Under a
thread swarm only the counters that do not depend on the interleaving
are compared (lookups, hits, misses, batch dedup, bytes): which drifted
request is planned first, and so splices from the other, does.

Swarm scale comes from the environment, with the defaults of
tests/test_serve_concurrent.py:

    REPRO_STRESS_THREADS   threads per swarm (default 8)
    REPRO_STRESS_ITERS     batches per thread (default 4)

No test asserts a wall-clock bound; the one coalescing count asserted
comes from one submitter filling a window through ``max_batch``.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.bench_schema import check_bench_file  # noqa: E402
from repro.core import PolytopeExtractor, gather  # noqa: E402
from repro.core import Box, Request, Select  # noqa: E402
from repro.dataplane import weather as ref_weather  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.serve import sharded as ref_sharded  # noqa: E402
from repro.serve.extraction import (  # noqa: E402
    ExtractionService as RefExtractionService)

from repro_torch import carry  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    check_bench_file as port_check_bench_file)
from repro_torch.analysis.plan_check import PlanVerificationError  # noqa: E402
from repro_torch.distributed import sharding as port_sharding  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.serve import (AdmissionQueue,  # noqa: E402
                               ExtractionService,
                               ShardedExtractionService, ShardedPlanCache,
                               deserialize_plan, serialize_plan)
from torch_specs import cube_spec, request_spec  # noqa: E402

N_THREADS = max(int(os.environ.get("REPRO_STRESS_THREADS", "8")), 2)
N_ITERS = max(int(os.environ.get("REPRO_STRESS_ITERS", "4")), 1)

# Counters that do not depend on how a swarm interleaves.
SWARM_COUNTERS = ("hits", "misses", "batch_dedup", "bytes_requested",
                  "bytes_read", "evictions")
ALL_COUNTERS = SWARM_COUNTERS + ("delta_hits", "delta_misses",
                                 "migrations", "plans_shipped",
                                 "plans_received")


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

def run_swarm(n_threads, fn):
    """Start ``n_threads`` threads on a barrier and re-raise the first
    exception any of them hit."""
    barrier = threading.Barrier(n_threads)
    errors = []

    def wrapped(tid):
        try:
            barrier.wait(timeout=30)
            fn(tid)
        except BaseException as e:   # noqa: BLE001 — surface everything
            errors.append(e)

    threads = [threading.Thread(target=wrapped, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "swarm deadlocked"
    if errors:
        raise errors[0]


def _port(req):
    return carry.request_from_spec(request_spec(req))


def _same_counters(port_stats, ref_stats, names):
    for name in names:
        assert getattr(port_stats, name) == getattr(ref_stats, name), name


def _values(res):
    assert isinstance(res.values, torch.Tensor)
    return res.values.numpy()


class Side:
    """One cube, its payload and its requests, in both packages."""

    def __init__(self, ref_cube, data, ref_requests):
        self.ref_cube = ref_cube
        self.port_cube = carry.datacube_from_spec(cube_spec(ref_cube))
        self.data = data
        self.tensor = torch.from_numpy(data)
        self.ref = list(ref_requests)
        self.port = [_port(r) for r in self.ref]
        ex = PolytopeExtractor(ref_cube)
        self.expected = [gather(data, ex.plan(r)[0]) for r in self.ref]

    def services(self, **kw):
        return (ShardedExtractionService(self.port_cube, device="cpu", **kw),
                ref_sharded.ShardedExtractionService(self.ref_cube, **kw))


@pytest.fixture(scope="module")
def weather():
    wc = ref_weather.WeatherCube(n=16, n_times=2, n_levels=2)
    return Side(wc.cube, wc.field_data(seed=0),
                ref_weather.request_population(wc))


@pytest.fixture(scope="module")
def irregular():
    icw = ref_weather.IrregularWeatherCube(n_lat=24, n_lon=48)
    requests = [
        icw.country_request("uk"),
        icw.country_request("france"),
        icw.seam_box_request(40.0, 60.0, -15.0, 15.0),
        icw.seam_box_request(40.0, 60.0, 345.0, 375.0),
        icw.timeseries_request(float(icw.latitudes[5]),
                               float(icw.lon_values[4]), 0.0, 100000.0),
    ]
    return Side(icw.cube, icw.field_data(seed=1), requests)


# ---------------------------------------------------------------------------
# The hash ring
# ---------------------------------------------------------------------------

def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [hashlib.sha256(rng.bytes(16)).hexdigest() for _ in range(n)]


class TestHashRing:
    @pytest.mark.parametrize("replicas", (1, 64))
    def test_routes_match_reference_through_add_and_remove(self, replicas):
        names = [f"s{i}" for i in range(4)]
        port = port_sharding.HashRing(names, replicas=replicas)
        ref = ref_sharding.HashRing(names, replicas=replicas)
        keys = _keys(2000, replicas)

        def same():
            assert port.nodes == ref.nodes
            assert [port.route(k) for k in keys] == \
                [ref.route(k) for k in keys]

        same()
        for ring in (port, ref):
            ring.add_node("s4")
        same()
        for ring in (port, ref):
            ring.remove_node("s1")
        same()
        for ring in (port, ref):
            ring.add_node("s1")
        same()

    def test_constants_and_key_point(self):
        assert port_sharding.PREFIX_HEX == ref_sharding.PREFIX_HEX
        assert port_sharding.RING_SPACE == ref_sharding.RING_SPACE
        for k in _keys(50, 3):
            assert port_sharding.key_point(k) == ref_sharding.key_point(k)

    def test_topology_errors(self):
        ring = port_sharding.HashRing(["a"])
        with pytest.raises(ValueError):
            ring.add_node("a")
        with pytest.raises(KeyError):
            ring.remove_node("zz")
        with pytest.raises(ValueError):
            port_sharding.HashRing(replicas=0)
        with pytest.raises(RuntimeError):
            port_sharding.HashRing().route("ff" * 32)


# ---------------------------------------------------------------------------
# submit_batch under contention
# ---------------------------------------------------------------------------

def _mix(n, tid):
    """Per-thread mix: duplicates + disjoint geometries, rotated per
    thread so threads collide on some keys (tests/test_serve_concurrent
    .py)."""
    picks = [(tid + j) % n for j in range(6)]
    return picks + picks[:2]


class TestSubmitBatchSwarm:
    def test_sharded_byte_identity_and_stats(self, weather):
        port_svc, ref_svc = weather.services(shards=4)
        n = len(weather.ref)

        def worker(tid):
            for _ in range(N_ITERS):
                idx = _mix(n, tid)
                results = port_svc.submit_batch(
                    [weather.port[i] for i in idx], weather.tensor)
                assert len(results) == len(idx)
                for i, res in zip(idx, results):
                    assert res.request is weather.port[i]
                    np.testing.assert_array_equal(_values(res),
                                                  weather.expected[i])

        def ref_worker(tid):
            for _ in range(N_ITERS):
                ref_svc.submit_batch([weather.ref[i] for i in
                                      _mix(n, tid)], weather.data)

        run_swarm(N_THREADS, worker)
        run_swarm(N_THREADS, ref_worker)
        s = port_svc.stats
        assert s.lookups == s.hits + s.misses
        assert s.delta_hits + s.delta_misses == s.misses
        covered = {(tid + j) % n for tid in range(N_THREADS)
                   for j in range(6)}
        distinct = len({weather.port[i].canonical_hash(port_svc.tol,
                                                       port_svc.periods)
                        for i in covered})
        assert s.misses == distinct == len(port_svc.shards)
        assert s.batch_dedup == 2 * N_THREADS * N_ITERS
        _same_counters(s, ref_svc.stats, SWARM_COUNTERS)

    def test_single_lock_service_parity(self, weather):
        port_svc = ExtractionService(weather.port_cube, device="cpu")
        ref_svc = RefExtractionService(weather.ref_cube)
        n = len(weather.ref)

        def worker(tid):
            for _ in range(N_ITERS):
                idx = [(tid + j) % n for j in range(4)]
                results = port_svc.submit_batch(
                    [weather.port[i] for i in idx], weather.tensor)
                for i, res in zip(idx, results):
                    np.testing.assert_array_equal(_values(res),
                                                  weather.expected[i])

        def ref_worker(tid):
            for _ in range(N_ITERS):
                ref_svc.submit_batch([weather.ref[(tid + j) % n]
                                      for j in range(4)], weather.data)

        run_swarm(N_THREADS, worker)
        run_swarm(N_THREADS, ref_worker)
        s = port_svc.stats
        assert s.lookups == s.hits + s.misses
        _same_counters(s, ref_svc.stats, SWARM_COUNTERS)

    def test_seam_shifted_requests_share_one_plan(self, irregular):
        """lon −15…15 and lon 345…375 hash identically: a swarm half on
        each contends on one cache entry and reads the same bytes."""
        port_svc, _ = irregular.services(shards=4)
        base, shifted = irregular.port[2], irregular.port[3]
        assert (base.canonical_hash(port_svc.tol, port_svc.periods)
                == shifted.canonical_hash(port_svc.tol, port_svc.periods))
        want = irregular.expected[2]
        np.testing.assert_array_equal(want, irregular.expected[3])
        assert want.size > 0

        def worker(tid):
            req = base if tid % 2 == 0 else shifted
            for _ in range(N_ITERS):
                res = port_svc.extract(req, irregular.tensor)
                np.testing.assert_array_equal(_values(res), want)

        run_swarm(N_THREADS, worker)
        s = port_svc.stats
        assert s.misses == 1
        assert s.hits == N_THREADS * N_ITERS - 1
        assert s.lookups == s.hits + s.misses

    def test_payload_on_another_device_raises(self, weather):
        port_svc, _ = weather.services(shards=2)
        with pytest.raises(ValueError, match="payload"):
            port_svc.submit_batch(weather.port[:2],
                                  torch.empty(weather.data.size,
                                              device="meta"))


# ---------------------------------------------------------------------------
# Async admission
# ---------------------------------------------------------------------------

class TestAdmissionQueue:
    def test_one_window_coalesces_across_callers(self, weather):
        """One submitter fills one window through ``max_batch`` (the long
        window never expires first): 4 hot geometries twice each fold
        into 4 plan lookups, exactly as in the JAX package."""
        idx = [0, 1, 2, 3, 0, 1, 2, 3]
        stats = []
        for svc, reqs, payload in (
                (weather.services(shards=4)[0], weather.port,
                 weather.tensor),
                (weather.services(shards=4)[1], weather.ref,
                 weather.data)):
            queue_cls = (AdmissionQueue if reqs is weather.port
                         else ref_sharded.AdmissionQueue)
            with queue_cls(svc, flat_data=payload, window_s=60.0,
                           max_batch=len(idx)) as queue:
                futs = [queue.submit(reqs[i]) for i in idx]
                results = [f.result(timeout=60) for f in futs]
                stats.append(queue.snapshot())
            for i, res in zip(idx, results):
                got = _values(res) if reqs is weather.port else res.values
                np.testing.assert_array_equal(got, weather.expected[i])
        port_adm, ref_adm = stats
        assert dataclasses.asdict(port_adm) == dataclasses.asdict(ref_adm)
        assert port_adm.windows == 1 and port_adm.coalesced == 4
        assert port_adm.coalescing_factor == 2.0

    def test_swarm_serves_every_caller(self, weather):
        hot = list(range(4))
        port_svc, _ = weather.services(shards=4)
        with AdmissionQueue(port_svc, flat_data=weather.tensor,
                            window_s=0.005, max_batch=256) as queue:
            def worker(tid):
                for j in range(N_ITERS):
                    i = hot[(tid + j) % len(hot)]
                    res = queue.extract(weather.port[i], timeout=60)
                    np.testing.assert_array_equal(_values(res),
                                                  weather.expected[i])

            run_swarm(N_THREADS, worker)
            adm = queue.snapshot()
        total = N_THREADS * N_ITERS
        assert adm.submitted == adm.served == total
        assert 0 <= adm.coalesced <= adm.submitted
        assert adm.windows >= 1 and adm.coalescing_factor >= 1.0

    def test_futures_resolve_out_of_band(self, weather):
        port_svc, _ = weather.services(shards=2)
        queue = AdmissionQueue(port_svc, flat_data=weather.tensor,
                               window_s=0.001)
        futs = [queue.submit(weather.port[i % 5]) for i in range(16)]
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(_values(fut.result(timeout=60)),
                                          weather.expected[i % 5])
        queue.close()

    def test_submit_after_close_raises(self, weather):
        queue = AdmissionQueue(weather.services(shards=2)[0],
                               flat_data=weather.tensor)
        queue.close()
        with pytest.raises(RuntimeError, match="closed"):
            queue.submit(weather.port[0])

    def test_service_error_propagates_to_futures(self, weather):
        class Exploding:
            def submit_batch(self, requests, flat_data=None):
                raise ValueError("boom")

        with AdmissionQueue(Exploding(), window_s=0.001) as queue:
            fut = queue.submit(weather.port[0])
            with pytest.raises(ValueError, match="boom"):
                fut.result(timeout=30)

    def test_bad_arguments_raise(self, weather):
        svc = weather.services(shards=2)[0]
        with pytest.raises(ValueError, match="window_s"):
            AdmissionQueue(svc, window_s=0.0)
        with pytest.raises(ValueError, match="max_batch"):
            AdmissionQueue(svc, max_batch=0)

    def test_irregular_swarm_verified(self, irregular):
        """verify=True runs the port's plan checker on every cold plan
        and on every window's union plan."""
        port_svc, _ = irregular.services(shards=4, verify=True)
        n = len(irregular.port)
        with AdmissionQueue(port_svc, flat_data=irregular.tensor,
                            window_s=0.005, max_batch=128) as queue:
            def worker(tid):
                for j in range(N_ITERS):
                    i = (tid + j) % n
                    res = queue.extract(irregular.port[i], timeout=60)
                    np.testing.assert_array_equal(_values(res),
                                                  irregular.expected[i])

            run_swarm(N_THREADS, worker)
            adm = queue.snapshot()
        assert adm.served == N_THREADS * N_ITERS
        s = port_svc.stats
        assert s.lookups == s.hits + s.misses


# ---------------------------------------------------------------------------
# Shard rebalance
# ---------------------------------------------------------------------------

class TestShardRebalance:
    N_KEYS = 2000

    def _caches(self, shards, keys):
        caches = (ShardedPlanCache(shards=shards,
                                   capacity_per_shard=self.N_KEYS),
                  ref_sharded.ShardedPlanCache(
                      shards=shards, capacity_per_shard=self.N_KEYS))
        for cache in caches:
            for i, k in enumerate(keys):
                cache.put(k, i)
        return caches

    def test_add_shard_moves_what_the_reference_moves(self):
        keys = _keys(self.N_KEYS, 1234)
        port, ref = self._caches(4, keys)
        before = {k: port.entry_of(k)[0] for k in keys}
        moved = port.add_shard("shard4")
        assert moved == ref.add_shard("shard4")
        after = {k: port.entry_of(k)[0] for k in keys}
        assert after == {k: ref.entry_of(k)[0] for k in keys}
        remapped = [k for k in keys if before[k] != after[k]]
        assert 0.10 <= len(remapped) / self.N_KEYS <= 0.35
        assert all(after[k] == "shard4" for k in remapped)
        assert moved == len(remapped)
        assert [port.get(k) for k in keys] == list(range(self.N_KEYS))
        assert port.shard_sizes() == ref.shard_sizes()

    def test_migrations_counter_matches_moved(self):
        port, ref = self._caches(4, _keys(500, 1236))
        moved = port.add_shard("shard4")
        assert port.stats.migrations == moved
        moved_back = port.remove_shard("shard4")
        assert port.stats.migrations == moved + moved_back
        ref.add_shard("shard4")
        ref.remove_shard("shard4")
        _same_counters(port.stats, ref.stats, ALL_COUNTERS)

    def test_remove_shard_conserves_stats(self):
        keys = _keys(300, 1237)
        port, _ = self._caches(3, keys)
        for k in keys:
            port.get(k)
        hits = port.stats.hits
        port.add_shard("doomed")
        port.remove_shard("doomed")
        assert port.stats.hits == hits == len(keys)

    def test_add_then_remove_restores_routing(self):
        keys = _keys(500, 1235)
        port, _ = self._caches(4, keys)
        before = {k: port.entry_of(k)[0] for k in keys}
        port.add_shard("extra")
        port.remove_shard("extra")
        assert {k: port.entry_of(k)[0] for k in keys} == before
        assert [port.get(k) for k in keys] == list(range(500))

    def test_topology_errors(self):
        cache = ShardedPlanCache(shards=["a"])
        with pytest.raises(ValueError):
            cache.add_shard("a")
        with pytest.raises(ValueError):
            cache.remove_shard("a")         # the last shard
        with pytest.raises(ValueError):
            ShardedPlanCache(shards=[])

    def test_rebalance_under_concurrent_service_load(self, weather):
        """Adding a shard mid-swarm never serves wrong bytes."""
        port_svc, _ = weather.services(shards=3)
        n = len(weather.port)
        stop = threading.Event()

        def admin(tid):
            if tid == 0:
                port_svc.add_shard("late-shard")
                stop.set()
                return
            j = 0
            while (not stop.is_set() or j < n) and j <= 10 * n:
                i = (tid + j) % n
                res = port_svc.extract(weather.port[i], weather.tensor)
                np.testing.assert_array_equal(_values(res),
                                              weather.expected[i])
                j += 1

        run_swarm(max(N_THREADS, 3), admin)
        assert "late-shard" in port_svc.shards.shard_names


# ---------------------------------------------------------------------------
# Cross-replica plan shipping
# ---------------------------------------------------------------------------

class TestPlanShipping:
    def test_wire_roundtrip_and_envelope(self, weather):
        port_svc, ref_svc = weather.services(shards=2)
        plan, _, key = port_svc.plan(weather.port[0])
        ref_plan, _, ref_key = ref_svc.plan(weather.ref[0])
        assert key == ref_key
        n = weather.port_cube.n_elements
        blob = serialize_plan(key, plan, n_elements=n)
        ref_blob = ref_sharded.serialize_plan(ref_key, ref_plan,
                                              n_elements=n)
        env, ref_env = pickle.loads(blob), pickle.loads(ref_blob)
        assert set(env) == set(ref_env) == {"plan", "n_elements", "key"}
        assert env["n_elements"] == ref_env["n_elements"] == n
        key2, plan2 = deserialize_plan(blob)
        assert key2 == key
        np.testing.assert_array_equal(plan2.offsets, ref_plan.offsets)
        np.testing.assert_array_equal(plan2.run_starts, ref_plan.run_starts)
        np.testing.assert_array_equal(plan2.run_lengths,
                                      ref_plan.run_lengths)

    def test_corrupt_shipment_rejected(self, weather):
        port_svc, _ = weather.services(shards=2)
        plan, _, key = port_svc.plan(weather.port[0])
        n = weather.port_cube.n_elements
        bad = type(plan)(offsets=plan.offsets + n,       # out of bounds
                         run_starts=plan.run_starts,
                         run_lengths=plan.run_lengths, coords={},
                         itemsize=plan.itemsize)
        blob = serialize_plan(key, bad, n_elements=n)
        with pytest.raises(PlanVerificationError):
            deserialize_plan(blob, verify=True)
        replica = ShardedExtractionService(weather.port_cube, shards=2,
                                           verify=True, device="cpu")
        with pytest.raises(PlanVerificationError):
            replica.receive_plan(blob)
        assert len(replica.shards) == 0

    def test_swarm_on_one_replica_warms_the_peer(self, weather):
        n = len(weather.port)
        pairs = []
        for side in ("port", "ref"):
            if side == "port":
                primary, peer = (ShardedExtractionService(
                    weather.port_cube, shards=4, name=name, device="cpu")
                    for name in ("replica0", "replica1"))
                reqs = weather.port
            else:
                primary, peer = (ref_sharded.ShardedExtractionService(
                    weather.ref_cube, shards=4, name=name)
                    for name in ("replica0", "replica1"))
                reqs = weather.ref
            primary.connect_peer(peer)

            def worker(tid, primary=primary, reqs=reqs):
                for j in range(N_ITERS):
                    primary.extract(reqs[(tid + j) % n])

            run_swarm(N_THREADS, worker)
            pairs.append((primary, peer))
        (primary, peer), (ref_primary, ref_peer) = pairs
        covered = sorted({(tid + j) % n for tid in range(N_THREADS)
                          for j in range(N_ITERS)})
        keys = {weather.port[i].canonical_hash(primary.tol, primary.periods)
                for i in covered}
        assert peer.stats.plans_received == len(keys)
        assert primary.stats.plans_shipped == peer.stats.plans_received
        _same_counters(primary.stats, ref_primary.stats,
                       ("plans_shipped", "misses", "hits"))
        _same_counters(peer.stats, ref_peer.stats, ("plans_received",))
        with pytest.raises(ValueError):
            primary.connect_peer(primary)
        for i in covered:
            res = peer.extract(weather.port[i], weather.tensor)
            assert res.cached
            np.testing.assert_array_equal(_values(res), weather.expected[i])
        assert peer.stats.misses == 0


# ---------------------------------------------------------------------------
# Delta planning behind the shards (tests/test_delta_planner.py)
# ---------------------------------------------------------------------------

LON_STEP = 10.0          # 360 / 36


def _lon_box(lon_lo, lon_hi):
    return Request([Select("datetime", [0.0]), Select("level", [1.0]),
                    Box(("lat", "lon"), [20.0, lon_lo], [70.0, lon_hi])])


@pytest.fixture(scope="module")
def drift():
    wc = ref_weather.IrregularWeatherCube(n_dates=2, times_per_day=3,
                                          n_levels=4, n_lat=24, n_lon=36)
    chain = [_lon_box(34.0 + k * LON_STEP, 76.0 + k * LON_STEP)
             for k in range(5)]
    return Side(wc.cube, wc.field_data(seed=5), chain)


class TestShardedDelta:
    def test_drift_stream_parity_and_counters(self, drift):
        port_svc, ref_svc = drift.services(shards=3, capacity_per_shard=64,
                                           verify=True)
        for i, (p, r) in enumerate(zip(drift.port, drift.ref)):
            res = port_svc.extract(p, drift.tensor)
            ref = ref_svc.extract(r, drift.data)
            np.testing.assert_array_equal(res.plan.offsets, ref.plan.offsets)
            np.testing.assert_array_equal(_values(res), drift.expected[i])
        assert port_svc.shards.stats.delta_hits == 4
        _same_counters(port_svc.stats, ref_svc.stats, ALL_COUNTERS)

    def test_signature_routing_is_consistent(self, drift):
        port_svc, _ = drift.services(shards=4, capacity_per_shard=64)
        for p in drift.port[:4]:
            port_svc.plan(p)
        populated = [n for n, h in port_svc.shards._hoods.items() if len(h)]
        assert len(populated) == 1

    def test_rebalance_migrates_neighborhoods(self, drift):
        port_svc, ref_svc = drift.services(shards=2, capacity_per_shard=64,
                                           verify=True)
        for svc, reqs in ((port_svc, drift.port), (ref_svc, drift.ref)):
            for r in reqs[:3]:
                svc.plan(r)
            assert svc.shards.stats.delta_hits == 2
            svc.shards.add_shard("shard-new")
            svc.plan(reqs[3])
            assert svc.shards.stats.delta_hits == 3
        _same_counters(port_svc.stats, ref_svc.stats, ALL_COUNTERS)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--mode", "extract", "--device", "cpu", "--grid-n", "32",
            "--threads", str(min(N_THREADS, 4)),
            "--bench-out", str(tmp_path / "bench.json"), *extra]


class TestLauncher:
    def test_run_extract_on_cpu(self, tmp_path, capsys):
        run = launcher.run_extract(launcher.parse_args(
            _argv(tmp_path, "--requests", "48")))
        assert "48 requests" in capsys.readouterr().out
        assert [str(d) for d in check_bench_file(tmp_path / "bench.json")] \
            == [str(d) for d in port_check_bench_file(
                tmp_path / "bench.json")] == []
        row = json.loads((tmp_path / "bench.json").read_text())["rows"][0]
        assert row == run.row and row["requests"] == 48
        assert row["scenario"] == "zipf1.3-grid32"
        assert row["device"] == "cpu" and not run.payload.is_cuda
        # the JAX package's cube, payload and requests, planned afresh
        wc = ref_weather.WeatherCube(n=32, n_times=4, n_levels=4)
        data = wc.field_data()
        np.testing.assert_array_equal(run.payload.numpy(), data)
        population = ref_weather.request_population(wc)
        ex = PolytopeExtractor(wc.cube)
        assert len(run.served) == 48
        for rank, res in run.served:
            np.testing.assert_array_equal(
                _values(res), gather(data, ex.plan(population[rank])[0]))
        s = run.service.stats
        assert s.lookups == s.hits + s.misses
        assert s.misses == len({r for r, _ in run.served})

    def test_no_requests_writes_a_valid_row(self, tmp_path):
        run = launcher.run_extract(launcher.parse_args(
            _argv(tmp_path, "--requests", "0")))
        assert run.served == [] and run.row["requests"] == 0
        assert check_bench_file(tmp_path / "bench.json") == [] \
            == port_check_bench_file(tmp_path / "bench.json")

    def test_guards(self, tmp_path, monkeypatch):
        assert launcher.parse_args([]).bench_out == "BENCH_torch_serve.json"
        assert launcher.parse_args([]).device == "cuda"
        assert launcher.parse_args([]).mode == "lm"
        with pytest.raises(SystemExit, match="zipf"):
            launcher.run_extract(launcher.parse_args(
                _argv(tmp_path, "--zipf-s", "1.0")))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        # lm mode is served now; like extract mode it needs the card
        # unless given --device cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launcher.main(["--mode", "lm"])
        args = launcher.parse_args(_argv(tmp_path)[:-2] + [
            "--device", "cuda", "--bench-out", str(tmp_path / "b.json")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launcher.run_extract(args)
        assert not (tmp_path / "b.json").exists()
