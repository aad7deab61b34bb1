"""The port's kernel modules == the JAX package's, byte for byte.

On the CPU every kernel module runs its plain PyTorch version; each is
held against the JAX package's reference *and* its Pallas kernel (in
interpret mode, float64 under ``jax.enable_x64``).  The device planner
is held against the host ``Slicer(fast_paths=False)`` and the JAX
pipeline called directly (the JAX ``DevicePlanner`` itself cannot run on
the installed jax).  All comparisons are exact: no float reduction in
this slice changes its order.  The CUDA kernels themselves are held
against the plain versions on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (ConvexPolytope, OrderedAxis, Request,  # noqa: E402
                        Select, Slicer, Span, TensorDatacube, Box, Polygon)
from repro.dataplane import weather as ref_weather  # noqa: E402
from repro.kernels.gather import kernel as ref_gather_kernel  # noqa: E402
from repro.kernels.gather import ops as ref_gather_ops  # noqa: E402
from repro.kernels.gather import ref as ref_gather  # noqa: E402
from repro.kernels.plan import kernel as ref_plan_kernel  # noqa: E402
from repro.kernels.plan import ref as ref_plan  # noqa: E402
from repro.kernels.slice import ref as ref_slice  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.gather import kernel as gk  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.kernels.gather import ref as gref  # noqa: E402
from repro_torch.kernels.plan import kernel as pk  # noqa: E402
from repro_torch.kernels.plan import ops as pops  # noqa: E402
from repro_torch.kernels.plan import ref as pref  # noqa: E402
from repro_torch.kernels.slice import ref as sref  # noqa: E402
from torch_specs import (assert_plans_equal, assert_stats_equal,  # noqa: E402
                         cube_spec, request_spec)

COUNTRY_NAMES = ("france", "germany", "italy", "norway", "uk")
NP_DTYPES = (np.float64, np.float32, np.int32, np.int16, np.uint8)


@pytest.fixture(scope="module")
def iwc():
    return ref_weather.IrregularWeatherCube()      # 96 × 192, cyclic lon


@pytest.fixture(scope="module")
def port_cube(iwc):
    return carry.datacube_from_spec(cube_spec(iwc.cube))


def _requests(iwc):
    reqs = {c: iwc.country_request(c) for c in COUNTRY_NAMES}
    reqs["seam_box"] = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
    reqs["whole_circle"] = iwc.seam_box_request(40.0, 50.0, -200.0, 200.0)
    reqs["all_levels"] = Request([
        Span("datetime", 0.0, 1e6), Span("level", 0.0, 2.0),
        Polygon(("lat", "lon"), ref_weather.COUNTRIES["germany"])])
    return reqs


class CapturingPlanner(port_core.DevicePlanner):
    """Records the pipeline inputs of every plan() call."""

    def _invoke(self, verts, valid, bases, scalars, g, max_rows):
        self.captured = (verts, valid, bases, scalars, g, max_rows)
        return super()._invoke(verts, valid, bases, scalars, g, max_rows)


def _pipeline_case(iwc, port_cube, name, dtype=np.float64):
    planner = CapturingPlanner(port_cube, device="cpu", dtype=dtype)
    req = carry.request_from_spec(request_spec(_requests(iwc)[name]))
    assert planner.plan(req) is not None, name
    verts, valid, bases, scalars, g, max_rows = planner.captured
    tensors = planner.pipeline_inputs(verts, valid, bases, scalars, g)
    kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows,
              cyclic=g["cyclic"])
    jax_args = (jnp.asarray(verts), jnp.asarray(valid),
                jnp.asarray(bases.astype(np.int32)),
                jnp.asarray(g["sv0"].astype(dtype)),
                jnp.asarray(g["rowoff"].astype(np.int32)),
                jnp.asarray(g["sv1"].astype(dtype)), jnp.asarray(scalars))
    return tensors, jax_args, kw


def _np(outs):
    return [np.asarray(o) for o in outs]


# -- gather: B1 and B2 ---------------------------------------------------------

class TestGatherParity:
    @pytest.mark.parametrize("dtype", NP_DTYPES)
    @pytest.mark.parametrize("d", (1, 3))
    def test_gather_rows(self, dtype, d):
        rng = np.random.default_rng(7)
        table = (rng.normal(size=(50, d)) * 100).astype(dtype)
        idx = rng.integers(0, 50, 37)
        got = gops.gather_rows(torch.from_numpy(table), idx)
        with jax.enable_x64(True):
            want = np.asarray(ref_gather.gather_rows(jnp.asarray(table),
                                                     idx))
        assert want.dtype == table.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.from_numpy(table).dtype

    def test_gather_rows_equals_pallas(self):
        rng = np.random.default_rng(8)
        table = rng.normal(size=(40, 2)).astype(np.float32)
        idx = rng.integers(0, 40, 17)
        got = gops.gather_rows(torch.from_numpy(table), idx)
        want = ref_gather_kernel.gather_rows(jnp.asarray(table), idx,
                                             interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("block", (4, 128))
    def test_gather_runs_past_the_end(self, block):
        rng = np.random.default_rng(9)
        flat = rng.normal(size=300).astype(np.float32)
        starts = np.concatenate([rng.integers(0, 300, 20), [299, 298, 0]])
        got = gref.gather_runs(torch.from_numpy(flat),
                               torch.from_numpy(starts), block)
        padded = jnp.concatenate([jnp.asarray(flat),
                                  jnp.zeros(block, jnp.float32)])
        want = ref_gather.gather_runs(padded, starts, block)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pallas = ref_gather_kernel.gather_runs(padded, starts, block,
                                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))

    def test_chunk_runs(self, iwc):
        plan = Slicer(iwc.cube).extract_plan(iwc.country_request("uk"))[0]
        for block in (4, 128):
            got = gops.chunk_runs(plan.run_starts, plan.run_lengths, block)
            want = ref_gather_ops.chunk_runs(plan.run_starts,
                                             plan.run_lengths, block)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("block", (4, 128))
    @pytest.mark.parametrize("name", ("uk", "seam_box", "all_levels"))
    def test_gather_plan_runs(self, iwc, name, block):
        plan = Slicer(iwc.cube).extract_plan(_requests(iwc)[name])[0]
        flat = np.arange(iwc.cube.n_elements, dtype=np.float32)
        got = gops.gather_plan_runs(torch.from_numpy(flat), plan.run_starts,
                                    plan.run_lengths, block=block)
        want = ref_gather_ops.gather_plan_runs(
            jnp.asarray(flat), plan.run_starts, plan.run_lengths,
            block=block)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), flat[plan.offsets])

    def test_indices_are_bounds_checked(self):
        table = torch.zeros(10, 1)
        with pytest.raises(IndexError):
            gops.gather_rows(table, np.array([10]))
        with pytest.raises(OverflowError):
            gops.gather_rows(table, np.array([2 ** 31]))


# -- the slicing core: B4 -----------------------------------------------------

class TestSliceExtentsParity:
    @pytest.mark.parametrize("seed", range(4))
    def test_float64(self, seed):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-5, 5, (64, 6))
        y = rng.uniform(-5, 5, (64, 6))
        valid = rng.random((64, 6)) > 0.2
        planes = rng.uniform(-5, 5, 64)
        x[:8, 0] = planes[:8]                      # on-plane vertices
        tol = 1e-9 * np.maximum(1.0, np.abs(x).max(1))
        got = sref.slice_minor_extents(
            torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(valid), torch.from_numpy(planes),
            torch.from_numpy(tol))
        with jax.enable_x64(True):
            want = ref_slice.slice_minor_extents(
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
                jnp.asarray(planes), jnp.asarray(tol))
            want = _np(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        assert got[0].dtype == torch.float64


# -- the planning pipeline: B3 ------------------------------------------------

class TestPlanPipelineParity:
    @pytest.mark.parametrize("name", COUNTRY_NAMES + (
        "seam_box", "whole_circle", "all_levels"))
    def test_ref_equals_jax_ref_float64(self, iwc, port_cube, name):
        tensors, jax_args, kw = _pipeline_case(iwc, port_cube, name)
        got = pref.plan_runs_2d(*tensors, **kw)
        with jax.enable_x64(True):
            want = _np(ref_plan.plan_runs_2d(*jax_args, **kw))
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)

    @pytest.mark.parametrize("name", ("germany", "uk", "seam_box"))
    def test_ref_equals_pallas_float64(self, iwc, port_cube, name):
        tensors, jax_args, kw = _pipeline_case(iwc, port_cube, name)
        got = pops.plan_runs_2d(*tensors, **kw)
        with jax.enable_x64(True):
            want = _np(ref_plan_kernel.plan_runs_2d(*jax_args, **kw,
                                                    interpret=True))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)

    @pytest.mark.parametrize("name", ("germany", "uk", "seam_box"))
    def test_ref_equals_jax_ref_float32(self, iwc, port_cube, name):
        tensors, jax_args, kw = _pipeline_case(iwc, port_cube, name,
                                               dtype=np.float32)
        assert tensors[0].dtype == torch.float32
        got = pref.plan_runs_2d(*tensors, **kw)
        want = _np(ref_plan.plan_runs_2d(*jax_args, **kw))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)

    @pytest.mark.parametrize("name", ("uk", "whole_circle"))
    def test_uncompacted_slots(self, iwc, port_cube, name):
        tensors, jax_args, kw = _pipeline_case(iwc, port_cube, name)
        got = pref.row_slots_2d(*tensors, **kw)
        with jax.enable_x64(True):
            slots = jax.jit(ref_plan.row_slots_2d, static_argnames=(
                "n0", "n1", "max_rows", "cyclic"))
            want = _np(slots(*jax_args, **kw))
        ok = got[2].numpy()
        np.testing.assert_array_equal(ok, want[2])
        np.testing.assert_array_equal(got[0].numpy()[ok], want[0][ok])
        np.testing.assert_array_equal(got[1].numpy()[ok], want[1][ok])
        assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])

    def test_no_jobs(self):
        z = torch.zeros
        out = pops.plan_runs_2d(
            z((0, 3, 2), dtype=torch.float64), z((0, 3), dtype=torch.bool),
            z(0, dtype=torch.int32), torch.arange(4.0, dtype=torch.float64),
            z(4, dtype=torch.int32), torch.arange(4.0, dtype=torch.float64),
            z(4, dtype=torch.float64), n0=4, n1=4, max_rows=8,
            cyclic=False)
        assert [o.numel() for o in out] == [0, 0, 3]


# -- the device planner: host parity and transparent fallback ----------------

def _slow_host(cube, req):
    return Slicer(cube, fast_paths=False).extract_plan(req)


class TestDevicePlannerParity:
    @pytest.mark.parametrize("name", COUNTRY_NAMES + (
        "seam_box", "whole_circle", "all_levels"))
    def test_weather_byte_identical(self, iwc, port_cube, name):
        req = _requests(iwc)[name]
        dev = port_core.DevicePlanner(port_cube, device="cpu").plan(
            carry.request_from_spec(request_spec(req)))
        assert dev is not None, name
        want = _slow_host(iwc.cube, req)
        np.testing.assert_array_equal(dev[0].offsets, want[0].offsets)
        np.testing.assert_array_equal(dev[0].run_starts,
                                      want[0].run_starts)
        np.testing.assert_array_equal(dev[0].run_lengths,
                                      want[0].run_lengths)
        assert_stats_equal(dev[1], want[1], name)
        assert dev[0].coords == {}

    def _grid(self, n=32):
        return TensorDatacube([OrderedAxis("t", np.arange(3.0)),
                               OrderedAxis("x", np.arange(float(n))),
                               OrderedAxis("y", np.arange(float(n)))])

    @pytest.mark.parametrize("case", ("triangle", "empty", "implicit_all"))
    def test_regular_grid(self, case):
        cube = self._grid()
        tri = np.array([[4.0, 2.0], [28.0, 9.0], [15.0, 30.0]])
        req = {
            "triangle": Request([Select("t", [1.0]),
                                 ConvexPolytope(("x", "y"), tri)]),
            "empty": Request([Box(("x", "y"), [100.0, 100.0],
                                  [120.0, 130.0])]),
            "implicit_all": Request([Box(("x", "y"), [3.0, 4.0],
                                         [10.0, 21.0])]),
        }[case]
        port = carry.datacube_from_spec(cube_spec(cube))
        dev = port_core.DevicePlanner(port, device="cpu").plan(
            carry.request_from_spec(request_spec(req)))
        assert dev is not None
        want = _slow_host(cube, req)
        np.testing.assert_array_equal(dev[0].offsets, want[0].offsets)
        assert_stats_equal(dev[1], want[1], case)

    @pytest.mark.parametrize("seed", range(8))
    def test_random_polygons(self, seed):
        cube = TensorDatacube([OrderedAxis("a", np.arange(24.0)),
                               OrderedAxis("b", np.arange(24.0))])
        rng = np.random.default_rng(seed)
        pts = rng.uniform(0, 23, (int(rng.integers(3, 8)), 2))
        req = Request([ConvexPolytope(("a", "b"), pts)])
        port = carry.datacube_from_spec(cube_spec(cube))
        dev = port_core.DevicePlanner(port, device="cpu").plan(
            carry.request_from_spec(request_spec(req)))
        want = _slow_host(cube, req)
        np.testing.assert_array_equal(dev[0].offsets, want[0].offsets)
        assert_stats_equal(dev[1], want[1], f"seed {seed}")

    @pytest.mark.parametrize("seed", range(8))
    def test_random_seam_boxes(self, iwc, port_cube, seed):
        rng = np.random.default_rng(100 + seed)
        lat = np.sort(rng.uniform(-85, 85, 2))
        lon_lo = rng.uniform(-180, 180)
        width = rng.uniform(1.0, 400.0)       # > 360 ⇒ whole circle
        req = iwc.seam_box_request(lat[0], lat[1], lon_lo, lon_lo + width)
        dev = port_core.DevicePlanner(port_cube, device="cpu").plan(
            carry.request_from_spec(request_spec(req)))
        want = _slow_host(iwc.cube, req)
        np.testing.assert_array_equal(dev[0].offsets, want[0].offsets)
        assert_stats_equal(dev[1], want[1], f"seed {seed}")

    def test_float32_mode_plans(self, iwc, port_cube):
        req = _requests(iwc)["germany"]
        dev = port_core.DevicePlanner(port_cube, device="cpu",
                                      dtype=np.float32).plan(
            carry.request_from_spec(request_spec(req)))
        want = _slow_host(iwc.cube, req)
        np.testing.assert_array_equal(dev[0].offsets, want[0].offsets)


class TestTransparentFallback:
    def test_octahedral_cube_falls_back(self):
        wc = ref_weather.WeatherCube(n=64, n_times=1, n_levels=1)
        port = carry.datacube_from_spec(cube_spec(wc.cube))
        req = carry.request_from_spec(request_spec(
            wc.country_request("france")))
        assert port_core.DevicePlanner(port, device="cpu").plan(req) is None
        fell_back = port_core.Slicer(port, device_planner=True,
                                     device="cpu").extract_plan(req)
        host = Slicer(wc.cube).extract_plan(wc.country_request("france"))
        assert_plans_equal(fell_back[0], host[0])

    def test_ineligible_request_falls_back(self, iwc, port_cube):
        ref_req = iwc.timeseries_request(51.5, 0.0, 0.0, 43200.0)
        req = carry.request_from_spec(request_spec(ref_req))
        assert port_core.DevicePlanner(port_cube,
                                       device="cpu").plan(req) is None
        fell_back = port_core.Slicer(port_cube, device_planner=True,
                                     device="cpu").extract_plan(req)
        assert_plans_equal(fell_back[0],
                           Slicer(iwc.cube).extract_plan(ref_req)[0])

    def test_slicer_routes_eligible_requests_to_device(self, iwc,
                                                       port_cube):
        req = carry.request_from_spec(request_spec(
            iwc.country_request("france")))
        via = port_core.Slicer(port_cube, device_planner=True, device="cpu",
                               verify=True).extract_plan(req)
        direct = port_core.DevicePlanner(port_cube, device="cpu").plan(req)
        assert_plans_equal(via[0], direct[0])
        assert via[0].coords == {}


# -- dispatch: the tensor's device decides --------------------------------------

class TestDispatch:
    def test_cpu_tensors_never_build_or_count(self, monkeypatch, iwc):
        def refuse(name):
            raise AssertionError("a CPU tensor reached the CUDA build")

        monkeypatch.setattr(_build, "library", refuse)
        before = dict(LAUNCHES)
        plan = Slicer(iwc.cube).extract_plan(iwc.country_request("uk"))[0]
        flat = torch.arange(iwc.cube.n_elements, dtype=torch.float64)
        gops.gather_plan_runs(flat, plan.run_starts, plan.run_lengths)
        gops.gather_rows(flat[:, None], plan.offsets)
        assert LAUNCHES == before

    def test_kernels_refuse_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            gk.gather_rows(torch.zeros(4, 1), torch.zeros(2, dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            gk.gather_runs(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                           4)
        with pytest.raises(ValueError, match="CUDA"):
            pk.plan_runs_2d(*[torch.zeros(1)] * 7, n0=1, n1=1, max_rows=8,
                            cyclic=False)

    def test_other_devices_raise(self):
        meta = torch.empty(8, device="meta")
        with pytest.raises(ValueError):
            gops.gather_rows(meta[:, None], np.array([1]))

    def test_entry_points_need_the_card(self, monkeypatch, port_cube):
        from repro_torch.serve import ExtractionService

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_core.DevicePlanner(port_cube)
        with pytest.raises(RuntimeError):
            port_core.PolytopeExtractor(port_cube)
        with pytest.raises(RuntimeError):
            port_core.Slicer(port_cube, device_planner=True)
        with pytest.raises(RuntimeError):
            ExtractionService(port_cube)
        with pytest.raises(RuntimeError):
            carry.payload_to_tensor(np.zeros(3))
        port_core.Slicer(port_cube)              # host planning needs none
        port_core.PolytopeExtractor(port_cube, device="cpu")

