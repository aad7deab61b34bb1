"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

All comparisons are byte for byte: the kernels copy or plan in integer
and float64/float32 arithmetic that rounds like the plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DevicePlanner, PolytopeExtractor,  # noqa: E402
                              Request, Slicer, Span)
from repro_torch.dataplane.weather import IrregularWeatherCube  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gather import kernel as gk  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.kernels.gather import ref as gref  # noqa: E402
from repro_torch.kernels.plan import kernel as pk  # noqa: E402
from repro_torch.kernels.plan import ref as pref  # noqa: E402
from repro_torch.serve import ExtractionService  # noqa: E402

pytestmark = pytest.mark.cuda

PLAN_CASES = ("germany", "uk", "seam_box", "whole_circle", "all_levels")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def iwc():
    return IrregularWeatherCube(n_levels=3)        # 96 × 192, cyclic lon


def _requests(iwc):
    reqs = {c: iwc.country_request(c) for c in ("germany", "uk", "norway")}
    reqs["seam_box"] = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
    reqs["whole_circle"] = iwc.seam_box_request(40.0, 50.0, -200.0, 200.0)
    reqs["all_levels"] = Request([
        Span("datetime", 0.0, float(iwc.datetime_values[-1])),
        Span("level", 0.0, float(iwc.n_levels - 1)),
        iwc.country_request("germany").shapes[2]])
    return reqs


def _bytes_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


class CapturingPlanner(DevicePlanner):
    """Records the pipeline inputs of the last plan() call."""

    def _invoke(self, verts, valid, bases, scalars, g, max_rows):
        self.captured = (verts, valid, bases, scalars, g, max_rows)
        return super()._invoke(verts, valid, bases, scalars, g, max_rows)


# -- B1 and B2 ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.int16, torch.uint8))
@pytest.mark.parametrize("d", (1, 3))
def test_gather_rows(cuda_device, dtype, d):
    gen = torch.Generator().manual_seed(0)
    table = (torch.randn(1000, d, generator=gen) * 100).to(dtype)
    idx = torch.randint(0, 1000, (777,), generator=gen, dtype=torch.int32)
    idx[-1] = 999
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    assert _bytes_equal(gk.gather_rows(table, idx),
                        gref.gather_rows(table, idx))


@pytest.mark.parametrize("block", (4, 128))
def test_gather_runs_past_the_end(cuda_device, block):
    gen = torch.Generator().manual_seed(1)
    flat = torch.randn(1000, generator=gen,
                       dtype=torch.float64).to(cuda_device)
    starts = torch.tensor([0, 500, 990, 998, 999], dtype=torch.int32,
                          device=cuda_device)
    got = gk.gather_runs(flat, starts, block)
    assert _bytes_equal(got, gref.gather_runs(flat, starts, block))
    assert not bool(got[-1, 1:].any())      # zero fill, no padded payload


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    table = torch.zeros(8, 2, device=cuda_device)
    with pytest.raises(TypeError):
        gk.gather_rows(table, torch.zeros(3, dtype=torch.int64,
                                          device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        gk.gather_rows(table.t(), torch.zeros(3, dtype=torch.int32,
                                              device=cuda_device))
    with pytest.raises(ValueError):
        gk.gather_runs(torch.zeros(8, device=cuda_device),
                       torch.zeros(2, dtype=torch.int32), 4)   # CPU starts


# -- B3 (with B4 inside) --------------------------------------------------------

@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_runs_2d(cuda_device, iwc, name, dtype):
    planner = CapturingPlanner(iwc.cube, device=cuda_device, dtype=dtype)
    assert planner.plan(_requests(iwc)[name]) is not None, name
    verts, valid, bases, scalars, g, max_rows = planner.captured
    tensors = planner.pipeline_inputs(verts, valid, bases, scalars, g)
    kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows, cyclic=g["cyclic"])
    got = pk.plan_runs_2d(*tensors, **kw)
    want = pref.plan_runs_2d(*tensors, **kw)
    for a, b in zip(got, want):
        assert _bytes_equal(a, b), name


# -- the main path ----------------------------------------------------------------

def test_extractor_end_to_end(cuda_device, iwc):
    data = iwc.field_data(seed=2)
    flat = torch.from_numpy(data).to(cuda_device)
    pe = PolytopeExtractor(iwc.cube, device_planner=True, burst_gather=True)
    host = Slicer(iwc.cube)
    for name, req in _requests(iwc).items():
        before = dict(LAUNCHES)
        res = pe.extract(req, flat)
        assert LAUNCHES["plan_runs_2d"] == before["plan_runs_2d"] + 1, name
        assert LAUNCHES["gather_runs"] == before["gather_runs"] + 1, name
        np.testing.assert_array_equal(res.plan.offsets,
                                      host.extract_plan(req)[0].offsets)
        assert res.values.is_cuda
        np.testing.assert_array_equal(res.values.cpu().numpy(),
                                      data[res.plan.offsets])


def test_service_union_read(cuda_device, iwc):
    data = iwc.field_data(seed=3)
    flat = torch.from_numpy(data).to(cuda_device)
    svc = ExtractionService(iwc.cube)
    reqs = list(_requests(iwc).values())
    before = LAUNCHES["gather_rows"]
    results = svc.submit_batch(reqs + reqs[:2], flat)
    assert LAUNCHES["gather_rows"] > before
    for res in results:
        assert res.values.is_cuda
        np.testing.assert_array_equal(res.values.cpu().numpy(),
                                      data[res.plan.offsets])
    assert svc.stats.batch_dedup == 2


def test_burst_gather_of_a_plan(cuda_device, iwc):
    plan = Slicer(iwc.cube).extract_plan(_requests(iwc)["all_levels"])[0]
    data = iwc.field_data(seed=4)
    flat = torch.from_numpy(data).to(cuda_device)
    got = gops.gather_plan_runs(flat, plan.run_starts, plan.run_lengths)
    np.testing.assert_array_equal(got.cpu().numpy(), data[plan.offsets])
