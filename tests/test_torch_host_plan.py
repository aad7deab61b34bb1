"""The port's host planner == the JAX package's, byte for byte.

Host planning is float64 numpy in both packages with the same logic, so
offsets, runs, coords and §5.2 slice statistics must be identical, with
no tolerance.  Every cube and request is built once from a plain numpy
spec (``repro_torch.carry``) so both packages plan the same arrays, and
the JAX package's plan verifier checks every port plan.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.plan_check import verify_plan  # noqa: E402
from repro.core import (Box, OrderedAxis, Polygon, Request, Select,  # noqa: E402
                        Slicer, Span, TensorDatacube, compress_plan,
                        decompress_plan)
from repro.core import (BoundingBoxExtractor,  # noqa: E402
                        TraditionalExtractor)
from repro.dataplane import weather as ref_weather  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.dataplane import weather as port_weather  # noqa: E402
from repro_torch.kernels import _casting  # noqa: E402
from torch_specs import (assert_plans_equal, assert_stats_equal,  # noqa: E402
                         cube_spec, request_spec)

REPO = Path(__file__).resolve().parents[1]
PORT_SRC = REPO / "src" / "repro_torch"
COUNTRY_NAMES = ("france", "germany", "italy", "norway", "uk")


def _self_check_cube():
    return TensorDatacube([OrderedAxis("t", np.arange(4.0)),
                           OrderedAxis("x", np.arange(32.0)),
                           OrderedAxis("y", np.arange(32.0))])


def _self_check_requests():
    # the JAX package's `python -m repro.analysis` self-check requests
    tri = np.array([[4.0, 2.0], [28.0, 9.0], [15.0, 30.0]])
    return {
        "box": Request([Select("t", [1.0]),
                        Box(("x", "y"), [3.0, 4.0], [10.0, 21.0])]),
        "triangle": Request([Select("t", [0.0]),
                             Polygon(("x", "y"), tri)]),
        "span_all": Request([Box(("t", "x"), [0.0, 0.0], [3.0, 31.0])]),
    }


def _weather_requests(iwc):
    reqs = {c: iwc.country_request(c) for c in COUNTRY_NAMES}
    reqs["seam_box"] = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
    reqs["seam_narrow"] = iwc.seam_box_request(-10.0, 10.0, -3.0, 2.0)
    reqs["whole_circle"] = iwc.seam_box_request(40.0, 50.0, -200.0, 200.0)
    reqs["timeseries"] = iwc.timeseries_request(51.5, 0.0, 0.0, 43200.0)
    reqs["all_levels"] = Request([
        Span("datetime", 0.0, 1e6), Span("level", 0.0, 2.0),
        Polygon(("lat", "lon"), ref_weather.COUNTRIES["uk"])])
    return reqs


@pytest.fixture(scope="module")
def iwc():
    return ref_weather.IrregularWeatherCube()      # 96 × 192, cyclic lon


@pytest.fixture(scope="module")
def port_iwc_cube(iwc):
    return carry.datacube_from_spec(cube_spec(iwc.cube))


def _check(ref_cube, port_cube, request, fast_paths, label):
    want = Slicer(ref_cube, fast_paths=fast_paths).extract_plan(request)
    port_req = carry.request_from_spec(request_spec(request))
    got = port_core.Slicer(port_cube,
                           fast_paths=fast_paths).extract_plan(port_req)
    assert_plans_equal(got[0], want[0], label)
    assert_stats_equal(got[1], want[1], label)
    verify_plan(got[0], datacube=ref_cube, stats=got[1])
    return got


# -- the package stands alone ----------------------------------------------

class TestImportGuard:
    def test_imports_with_jax_blocked(self):
        code = (
            "import sys, pkgutil, importlib\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._libs == {}, 'kernels built at import'\n"
            "print(len(names))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.strip()) >= 20

    def test_recsys_modules_run_with_jax_blocked(self):
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch\n"
            "from repro_torch import configs\n"
            "from repro_torch.configs import common, deepfm, dlrm_rm2\n"
            "from repro_torch.dataplane.recsys import ClickStream\n"
            "from repro_torch.models.layers import MLP\n"
            "from repro_torch.models.recsys import DLRM, DeepFM\n"
            "b = ClickStream(n_sparse=4, rows=128).batch(0, 8)\n"
            "m = DLRM(configs.get_config('dlrm-rm2', smoke=True), "
            "device='cpu')\n"
            "with torch.no_grad():\n"
            "    y = m(torch.from_numpy(b['dense']), "
            "torch.from_numpy(b['bags']))\n"
            "assert y.shape == (8,) and bool(torch.isfinite(y).all())\n"
            "f = DeepFM(configs.get_config('deepfm', smoke=True), "
            "device='cpu')\n"
            "b = ClickStream(n_sparse=6, rows=64).batch(0, 8)\n"
            "with torch.no_grad():\n"
            "    y = f(torch.from_numpy(b['bags']))\n"
            "assert y.shape == (8,) and bool(torch.isfinite(y).all())\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._libs == {}, 'kernels built on the CPU path'\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr

    def test_nequip_modules_run_with_jax_blocked(self):
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch\n"
            "from repro_torch import carry, configs\n"
            "from repro_torch.configs import common, nequip as cfgs\n"
            "from repro_torch.dataplane.graph import molecule_batch\n"
            "from repro_torch.kernels.segment import kernel, ops, ref\n"
            "from repro_torch.models.nequip import (NequIP, "
            "nequip_energy_forces)\n"
            "b = {k: torch.from_numpy(v) if hasattr(v, 'dtype') else v "
            "for k, v in molecule_batch(4).items()}\n"
            "m = NequIP(configs.get_config('nequip', smoke=True), "
            "device='cpu')\n"
            "e, f = nequip_energy_forces(m, b['node_feat'], "
            "b['positions'], b['edge_index'], graph_ids=b['graph_ids'], "
            "n_graphs=4)\n"
            "assert e.shape == (4,) and f.shape == (120, 3)\n"
            "assert bool(torch.isfinite(f).all())\n"
            "assert 'minibatch_lg' in common.GNN_SHAPES\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._libs == {}, 'kernels built on the CPU path'\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr

    def test_lm_modules_run_with_jax_blocked(self):
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "import numpy as np, torch\n"
            "from repro_torch import carry, configs\n"
            "from repro_torch.configs import common, glm4_9b, yi_34b\n"
            "from repro_torch.kernels.paged_attn import kernel, ops, ref\n"
            "from repro_torch.models import attention, transformer as tf\n"
            "from repro_torch.serve.engine import (EngineConfig, Request, "
            "ServeEngine)\n"
            "from repro_torch.serve.kv_cache import PagedKVCache\n"
            "from repro_torch.launch import serve\n"
            "cfg = configs.get_config('yi-34b', smoke=True)\n"
            "e = ServeEngine(tf.init_params(cfg, device='cpu'), cfg, "
            "EngineConfig(max_batch=2, max_seq=32, page_size=4, "
            "n_pages=16), device='cpu')\n"
            "for n in (3, 9, 5):\n"
            "    e.submit(Request(prompt=np.arange(n, dtype=np.int32), "
            "max_new_tokens=4))\n"
            "done = e.run()\n"
            "assert [len(r.out_tokens) for r in done] == [4, 4, 4]\n"
            "assert 'decode_32k' in common.LM_SHAPES\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build, LAUNCHES\n"
            "assert _build._libs == {}, 'kernels built on the CPU path'\n"
            "assert LAUNCHES['paged_decode_attention'] == 0\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr

    def test_source_names_neither_jax_nor_reference_package(self):
        bad_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
        bad_name = re.compile(r"\brepro\b(?!_torch)")
        files = [f for f in PORT_SRC.rglob("*") if f.is_file()
                 and f.suffix in (".py", ".cu", ".cuh")]
        assert len(files) >= 25
        for f in files:
            text = f.read_text()
            assert not bad_import.search(text), f
            assert not bad_name.search(text), f


# -- host plan parity ---------------------------------------------------------

class TestSelfCheckParity:
    @pytest.mark.parametrize("fast_paths", (True, False))
    @pytest.mark.parametrize("name", ("box", "triangle", "span_all"))
    def test_plan_and_stats(self, name, fast_paths):
        cube = _self_check_cube()
        port_cube = carry.datacube_from_spec(cube_spec(cube))
        _check(cube, port_cube, _self_check_requests()[name], fast_paths,
               name)


class TestIrregularWeatherParity:
    @pytest.mark.parametrize("fast_paths", (True, False))
    @pytest.mark.parametrize("name", COUNTRY_NAMES + (
        "seam_box", "seam_narrow", "whole_circle", "timeseries",
        "all_levels"))
    def test_plan_and_stats(self, iwc, port_iwc_cube, name, fast_paths):
        _check(iwc.cube, port_iwc_cube, _weather_requests(iwc)[name],
               fast_paths, name)

    def test_port_weather_cube_equals_carried_cube(self, iwc, port_iwc_cube):
        own = port_weather.IrregularWeatherCube()
        assert own.cube.axis_names == port_iwc_cube.axis_names
        assert own.cube.n_elements == iwc.cube.n_elements
        req = own.country_request("uk")
        a = port_core.Slicer(own.cube).extract_plan(req)[0]
        b = port_core.Slicer(port_iwc_cube).extract_plan(req)[0]
        assert_plans_equal(a, b)
        np.testing.assert_array_equal(own.field_data(3), iwc.field_data(3))
        np.testing.assert_array_equal(own.latitudes, iwc.latitudes)

    @pytest.mark.parametrize("seed", range(6))
    def test_random_seam_boxes(self, iwc, port_iwc_cube, seed):
        rng = np.random.default_rng(seed)
        lat = np.sort(rng.uniform(-85, 85, 2))
        lon_lo = rng.uniform(-180, 180)
        width = rng.uniform(1.0, 400.0)
        req = iwc.seam_box_request(lat[0], lat[1], lon_lo, lon_lo + width)
        _check(iwc.cube, port_iwc_cube, req, True, f"seed {seed}")


class TestOctahedralParity:
    @pytest.mark.parametrize("name", ("france", "uk"))
    def test_country_plan(self, name):
        wc = ref_weather.WeatherCube(n=32, n_times=2, n_levels=2)
        port_cube = carry.datacube_from_spec(cube_spec(wc.cube))
        _check(wc.cube, port_cube, wc.country_request(name, level=1.0),
               True, name)

    def test_request_population(self):
        ref_pop = ref_weather.request_population(ref_weather.WeatherCube())
        port_pop = port_weather.request_population(
            port_weather.WeatherCube())
        assert len(ref_pop) == len(port_pop)
        for a, b in zip(ref_pop, port_pop):
            assert a.canonical_hash() == b.canonical_hash()


# -- request identity: the keys the plan cache and delta index use ----------

class TestRequestKeys:
    def test_canonical_hash_and_signature(self, iwc):
        periods = iwc.cube.axis_periods()
        for name, req in _weather_requests(iwc).items():
            port = carry.request_from_spec(request_spec(req))
            assert port.canonical_hash(1e-9, periods) == \
                req.canonical_hash(1e-9, periods), name
            sig, anchor = port.shape_signature()
            want_sig, want_anchor = req.shape_signature()
            assert sig == want_sig and anchor == want_anchor, name

    def test_union_path_disk_specs(self):
        from repro.core import Disk, Path as RPath, Union

        req = Request([Union([Disk(("x", "y"), [5.0, 6.0], 3.0),
                              Box(("x", "y"), [1.0, 1.0], [2.0, 3.0])]),
                       RPath(("t", "x"), Box(("x",), [-0.5], [0.5]),
                             np.array([[0.0, 3.0], [2.0, 9.0]]))])
        port = carry.request_from_spec(request_spec(req))
        assert port.canonical_hash() == req.canonical_hash()
        assert len(port.polytopes()) == len(req.polytopes())


# -- plan codec and baselines -------------------------------------------------

class TestPlanCodecAndBaselines:
    def test_compressed_plan_round_trip(self, iwc, port_iwc_cube):
        req = carry.request_from_spec(
            request_spec(iwc.country_request("france")))
        plan = port_core.Slicer(port_iwc_cube).extract_plan(req)[0]
        cp = port_core.compress_plan(plan)
        want = compress_plan(Slicer(iwc.cube).extract_plan(
            iwc.country_request("france"))[0])
        np.testing.assert_array_equal(cp.start_gaps, want.start_gaps)
        np.testing.assert_array_equal(cp.run_lengths, want.run_lengths)
        assert cp.base == want.base
        back = port_core.decompress_plan(cp)
        np.testing.assert_array_equal(back.offsets,
                                      decompress_plan(want).offsets)

    def test_compress_rejects_i32_gap_overflow(self):
        big = 2 ** 31 + 10
        plan = port_core.ExtractionPlan(
            offsets=np.array([0, big], np.int64),
            run_starts=np.array([0, big], np.int64),
            run_lengths=np.array([1, 1], np.int64), coords={})
        with pytest.raises(OverflowError):
            port_core.compress_plan(plan)

    @pytest.mark.parametrize("name", ("germany", "uk", "seam_box"))
    def test_bounding_box_and_whole_field(self, iwc, port_iwc_cube, name):
        req = _weather_requests(iwc)[name]
        port_req = carry.request_from_spec(request_spec(req))
        assert_plans_equal(
            port_core.BoundingBoxExtractor(port_iwc_cube).plan(port_req),
            BoundingBoxExtractor(iwc.cube).plan(req), name)
        fields = ("lat", "lon")
        assert port_core.TraditionalExtractor(
            port_iwc_cube, fields).nbytes(port_req) == \
            TraditionalExtractor(iwc.cube, fields).nbytes(req)


# -- bounds-checked int32 casts -----------------------------------------------

class TestCheckedCast:
    @pytest.mark.parametrize("kind", ("numpy", "tensor"))
    def test_casts_in_range(self, kind):
        vals = np.array([0, 5, 2 ** 31 - 1], np.int64)
        arr = vals if kind == "numpy" else torch.from_numpy(vals)
        out = _casting.checked_cast_i32(arr)
        if kind == "numpy":
            assert out.dtype == np.int32
        else:
            assert out.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(out), vals)

    @pytest.mark.parametrize("kind", ("numpy", "tensor"))
    def test_overflow_and_bounds_raise(self, kind):
        def wrap(a):
            a = np.asarray(a, np.int64)
            return a if kind == "numpy" else torch.from_numpy(a)

        with pytest.raises(OverflowError):
            _casting.checked_cast_i32(wrap([2 ** 31]))
        with pytest.raises(IndexError):
            _casting.checked_cast_i32(wrap([10]), n_elements=10)
        with pytest.raises(IndexError):
            _casting.checked_cast_i32(wrap([-1]))
        out = _casting.checked_cast_i32(wrap([-1, 3]),
                                        allow_negative_one=True)
        np.testing.assert_array_equal(np.asarray(out), [-1, 3])
        with pytest.raises(OverflowError):
            _casting.ensure_i32_addressable(2 ** 31 + 1)
