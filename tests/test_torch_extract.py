"""The port's whole extraction slice == the JAX package's, byte for byte.

``PolytopeExtractor(device_planner=True, burst_gather=True)`` and
``ExtractionService`` run on CPU tensors (``device="cpu"``: the plain
PyTorch versions of the kernels) and must give the values, plans and
cache counters the JAX package gives on the same request stream.  The
delta planner's splice-or-``None`` decision follows the JAX package's
planner, drift by drift.  All comparisons are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import (Box, DeltaPlanner, PolytopeExtractor,  # noqa: E402
                        Request, Select, Span, Polygon)
from repro.core import BoundingBoxExtractor  # noqa: E402
from repro.dataplane import weather as ref_weather  # noqa: E402
from repro.serve.extraction import ExtractionService  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.analysis.plan_check import verify_plan  # noqa: E402
from repro_torch.serve import ExtractionService as PortService  # noqa: E402
from repro_torch.serve import shared_union_gather  # noqa: E402
from torch_specs import (assert_plans_equal, assert_stats_equal,  # noqa: E402
                         cube_spec, request_spec)

COUNTRY_NAMES = ("france", "germany", "italy", "norway", "uk")
COUNTERS = ("hits", "misses", "evictions", "batch_dedup", "bytes_requested",
            "bytes_read", "delta_hits", "delta_misses", "migrations",
            "plans_shipped", "plans_received")


@pytest.fixture(scope="module")
def iwc():
    return ref_weather.IrregularWeatherCube()      # 96 × 192, cyclic lon


@pytest.fixture(scope="module")
def port_cube(iwc):
    return carry.datacube_from_spec(cube_spec(iwc.cube))


@pytest.fixture(scope="module")
def data(iwc):
    return iwc.field_data(seed=5)


def _port(req):
    return carry.request_from_spec(request_spec(req))


def _requests(iwc):
    reqs = {c: iwc.country_request(c) for c in COUNTRY_NAMES}
    reqs["seam_box"] = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
    reqs["all_levels"] = Request([
        Span("datetime", 0.0, 1e6), Span("level", 0.0, 2.0),
        Polygon(("lat", "lon"), ref_weather.COUNTRIES["germany"])])
    reqs["timeseries"] = iwc.timeseries_request(51.5, 0.0, 0.0, 43200.0)
    return reqs


# -- PolytopeExtractor ------------------------------------------------------------

class TestExtractorParity:
    @pytest.mark.parametrize("name", COUNTRY_NAMES + (
        "seam_box", "all_levels", "timeseries"))
    def test_device_plan_burst_gather(self, iwc, port_cube, data, name):
        req = _requests(iwc)[name]
        host = PolytopeExtractor(iwc.cube).extract(req, data)
        burst = PolytopeExtractor(iwc.cube, burst_gather=True).extract(
            req, jnp.asarray(data.astype(np.float32)))
        pe = port_core.PolytopeExtractor(port_cube, device_planner=True,
                                         burst_gather=True, device="cpu",
                                         verify=True)
        res = pe.extract(_port(req), torch.from_numpy(data))
        assert isinstance(res.values, torch.Tensor)
        np.testing.assert_array_equal(res.values.numpy(), host.values)
        np.testing.assert_array_equal(res.values.numpy().astype(np.float32),
                                      np.asarray(burst.values))
        np.testing.assert_array_equal(res.plan.offsets, host.plan.offsets)
        assert_stats_equal(res.stats, host.stats, name)

    @pytest.mark.parametrize("name", ("uk", "seam_box"))
    def test_per_element_gather(self, iwc, port_cube, data, name):
        req = _requests(iwc)[name]
        host = PolytopeExtractor(iwc.cube).extract(req, data)
        for use_kernel in (False, True):
            res = port_core.PolytopeExtractor(
                port_cube, use_kernel=use_kernel, device="cpu").extract(
                    _port(req), torch.from_numpy(data))
            np.testing.assert_array_equal(res.values.numpy(), host.values)
            assert_plans_equal(res.plan, host.plan, name)

    def test_numpy_payload_keeps_host_path(self, iwc, port_cube, data):
        req = iwc.country_request("norway")
        res = port_core.PolytopeExtractor(port_cube, device="cpu").extract(
            _port(req), data)
        assert isinstance(res.values, np.ndarray)
        np.testing.assert_array_equal(
            res.values, PolytopeExtractor(iwc.cube).extract(req, data).values)

    def test_payload_on_another_device_raises(self, iwc, port_cube):
        pe = port_core.PolytopeExtractor(port_cube, device="cpu")
        with pytest.raises(ValueError, match="payload"):
            pe.extract(_port(iwc.country_request("uk")),
                       torch.empty(iwc.cube.n_elements, device="meta"))

    def test_bounding_box_values(self, iwc, port_cube, data):
        req = iwc.country_request("italy")
        want = BoundingBoxExtractor(iwc.cube).extract(req, data)
        got = port_core.BoundingBoxExtractor(port_cube).extract(
            _port(req), torch.from_numpy(data))
        np.testing.assert_array_equal(got.values.numpy(), want.values)

    def test_float32_payload(self, iwc, port_cube, data):
        flat = data.astype(np.float32)
        req = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
        res = port_core.PolytopeExtractor(
            port_cube, device_planner=True, burst_gather=True,
            device="cpu").extract(_port(req), torch.from_numpy(flat))
        assert res.values.dtype == torch.float32
        np.testing.assert_array_equal(res.values.numpy(),
                                      flat[res.plan.offsets])


# -- ExtractionService --------------------------------------------------------------

def _population(iwc):
    pop = list(_requests(iwc).values())
    for name in COUNTRY_NAMES:
        for dt in (0.0, 21600.0):
            for lev in (0.0, 1.0):
                pop.append(iwc.country_request(name, datetime=dt, level=lev))
    step = 360.0 / iwc.n_lon
    for k in (1, 2, 5):
        pop.append(iwc.seam_box_request(35.0, 62.0, -25.0 + k * step,
                                        25.0 + k * step))
    return pop


def _stream(iwc, seed, n=48):
    pop = _population(iwc)
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(pop) + 1) ** 1.1
    return [pop[i] for i in rng.choice(len(pop), n, p=w / w.sum())]


class TestServiceParity:
    @pytest.mark.parametrize("capacity,delta,seed", [
        (1024, True, 0), (1024, False, 1), (3, True, 2), (1024, True, 3)])
    def test_stream(self, iwc, port_cube, data, capacity, delta, seed):
        stream = _stream(iwc, seed)
        ref_svc = ExtractionService(iwc.cube, capacity=capacity, delta=delta)
        svc = PortService(port_cube, capacity=capacity, delta=delta,
                          device="cpu", verify=seed == 3)
        flat = torch.from_numpy(data)
        for b in range(0, len(stream), 8):
            batch = stream[b:b + 8]
            want = ref_svc.submit_batch(batch, data)
            got = svc.submit_batch([_port(r) for r in batch], flat)
            for g, w in zip(got, want):
                assert g.key == w.key and g.cached == w.cached
                assert_plans_equal(g.plan, w.plan)
                assert isinstance(g.values, torch.Tensor)
                np.testing.assert_array_equal(g.values.numpy(), w.values)
        for name in COUNTERS:
            assert getattr(svc.stats, name) == getattr(ref_svc.stats, name), \
                name
        if delta:
            assert svc.stats.delta_hits > 0

    def test_plan_only_batches(self, iwc, port_cube):
        stream = _stream(iwc, 4, n=16)
        ref_svc = ExtractionService(iwc.cube)
        svc = PortService(port_cube, device="cpu")
        want = ref_svc.submit_batch(stream)
        got = svc.submit_batch([_port(r) for r in stream])
        for g, w in zip(got, want):
            assert g.values is None and w.values is None
            assert_plans_equal(g.plan, w.plan)
        assert svc.stats.misses == ref_svc.stats.misses

    def test_empty_plans_give_empty_values(self, port_cube, iwc):
        svc = PortService(port_cube, device="cpu")
        far = _port(iwc.seam_box_request(35.0, 35.0001, 10.0, 10.0001))
        res = svc.extract(far, torch.zeros(iwc.cube.n_elements))
        assert res.plan.n_points == 0
        assert isinstance(res.values, torch.Tensor)
        assert res.values.numel() == 0

    def test_union_read_verified(self, port_cube, iwc, data):
        reqs = [_port(iwc.country_request(c)) for c in ("uk", "france")]
        svc = PortService(port_cube, device="cpu")
        results = svc.submit_batch(reqs)
        plans = {r.key: r.plan for r in results}
        requested, read, _ = shared_union_gather(
            port_cube, results, plans, torch.from_numpy(data), verify=True)
        assert requested == read == sum(p.nbytes for p in plans.values())
        for r in results:
            np.testing.assert_array_equal(r.values.numpy(),
                                          data[r.plan.offsets])
            verify_plan(r.plan, datacube=port_cube)


# -- DeltaPlanner: the splice-or-None decision, drift by drift ------------------

LON_STEP = 10.0          # 360 / 36
DT_STEP = 28800.0        # 86400 / 3 times per day


def _lon_box(lon_lo, lon_hi, datetime=2 * DT_STEP, level=1.0):
    return Request([Select("datetime", [datetime]), Select("level", [level]),
                    Box(("lat", "lon"), [34.0, lon_lo], [76.0, lon_hi])])


@pytest.fixture(scope="module")
def drift_cubes():
    wc = ref_weather.IrregularWeatherCube(n_dates=2, times_per_day=3,
                                          n_levels=4, n_lat=24, n_lon=36)
    ref_ex = PolytopeExtractor(wc.cube)
    port_cube = carry.datacube_from_spec(cube_spec(wc.cube))
    port_ex = port_core.PolytopeExtractor(port_cube, device="cpu")
    return (wc, DeltaPlanner(wc.cube, slicer=ref_ex.slicer), ref_ex,
            port_core.DeltaPlanner(port_cube, slicer=port_ex.slicer), port_ex)


class TestDeltaParity:
    @pytest.mark.parametrize("lev_k", (-1, 0, 1))
    @pytest.mark.parametrize("lon_k", (-6, -1, 0, 1, 6))
    def test_splice_decision_and_plan(self, drift_cubes, lon_k, lev_k):
        wc, ref_dp, ref_ex, port_dp, port_ex = drift_cubes
        r_old = _lon_box(34.0, 76.0)
        for dt_k in (-2, -1, 0, 1, 2):
            if lon_k == lev_k == dt_k == 0:
                continue
            r_new = _lon_box(34.0 + lon_k * LON_STEP, 76.0 + lon_k * LON_STEP,
                             datetime=(2 + dt_k) * DT_STEP,
                             level=1.0 + lev_k)
            a_old = r_old.shape_signature()[1]
            a_new = r_new.shape_signature()[1]
            shifts = ref_dp.axis_shifts(a_old, a_new)
            assert port_dp.axis_shifts(a_old, a_new) == shifts
            p_old, s_old = ref_ex.plan(r_old)
            want = ref_dp.splice(r_new, r_old, p_old, s_old, shifts)
            po_old, ps_old = port_ex.plan(_port(r_old))
            got = port_dp.splice(_port(r_new), _port(r_old), po_old, ps_old,
                                 shifts)
            label = f"lon {lon_k} lev {lev_k} dt {dt_k}"
            assert (got is None) == (want is None), label
            if lev_k == -1:
                # the reference declines shifts onto the level axis's end
                assert got is None, label
            if got is not None:
                assert_plans_equal(got[0], want[0], label)
                assert_stats_equal(got[1], want[1], label)
