"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only the port, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The comparisons of B1-B7 are byte for byte: those kernels copy or plan
in integer and float64/float32 arithmetic that rounds like the plain
versions, and the summing kernels (B6, B7) add in the plain versions'
order.  B8 (paged decode attention) sums its float32 scores, softmax and
V products in its own order (per step of tokens, then across warps and
KV splits): it is held against its plain version within rtol = atol =
2e-5 in float32 and 2e-2 in bfloat16, the JAX kernel tests' tolerances,
and in bfloat16 also within 2^-7 of the largest |output| (one bf16 ulp
at the top of the output, as ``chip_smoke.py`` holds it).  Each B8 case
asserts which of its two kernels launched: the tensor-core one for bf16
with Dh in {16, 32, 64, 128} and G <= 16, the CUDA-core one otherwise.
So does each B6 case: the tiled kernel for rows of fewer than
``NARROW_ROW_BYTES`` (128) bytes, the wide one otherwise.  B3 runs as one launch a call.
The batched crop planner runs as one launch per entry point
(``batched_plan_2d``, ``batched_extract_2d``), with no launch of B4 on its
own or of B1 and no host sync, on the layouts of
``tests/torch_batched_cases.py``; a bool field's values come back as
int32 on the card as on the CPU.  The MoE routing and layer and MLA run
no kernel of the port (plain PyTorch and cuBLAS on the card): routing is
byte-equal to the CPU's on the same logits, the layers within
rtol = atol = 2e-5 in float32.  Fault C14's read (one run of 2³¹
elements) is byte-equal to its payload, and ``quantized_psum`` on an
NCCL group of one rank to its arithmetic on the CPU.
"""

import contextlib
import dataclasses

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
from repro_torch.kernels.paged_attn import kernel as pak  # noqa: E402
from repro_torch.kernels.paged_attn import ops as paops  # noqa: E402
from repro_torch.kernels.paged_attn import ref as paref  # noqa: E402
from repro_torch.kernels.plan import kernel as pk  # noqa: E402
from repro_torch.kernels.plan import ref as pref  # noqa: E402
from repro_torch.kernels.segment import kernel as segk  # noqa: E402
from repro_torch.kernels.segment import ops as segops  # noqa: E402
from repro_torch.kernels.segment import ref as segref  # noqa: E402
from repro_torch.kernels.slice import kernel as sk  # noqa: E402
from repro_torch.kernels.slice import ref as sref  # noqa: E402
from repro_torch.serve import ExtractionService  # noqa: E402
from torch_batched_cases import AXIS0 as BATCHED_AXIS0  # noqa: E402
from torch_batched_cases import AXIS1 as BATCHED_AXIS1  # noqa: E402
from torch_batched_cases import CASES as BATCHED_CASES  # noqa: E402
from torch_batched_cases import random_layer as batched_random_layer  # noqa: E402,E501
from torch_plan_cases import PLAN_SCAN_CASES, plan_scan_case  # noqa: E402
import torch_spmd_cases as spmd_cases  # noqa: E402

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


# -- B1, B2 and the union slices ----------------------------------------------

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


B1_DTYPES = (torch.uint8, torch.int16, torch.float32, torch.float64)
B1_WIDTHS = (1, 2, 3, 7, 16, 64, 250, 256, 1024)


def _b1_ids(gen, n, m):
    """m ids into n rows, repeats among them, the first and the last row
    included."""
    idx = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32)
    idx[0] = n - 1
    if m > 1:
        idx[-1] = 0
        idx[m // 2] = idx[0]
    return idx


@pytest.mark.parametrize("dtype", B1_DTYPES)
@pytest.mark.parametrize("d", B1_WIDTHS)
def test_gather_rows_every_layout(cuda_device, dtype, d):
    """B1 at 1-, 2-, 4- and 8-byte elements and rows of 1-1024 of them,
    on a table and on a view of it one element off 16-byte alignment
    (through ``ops.gather_plan_rows``), M of 1, 31, 33 and one that is no
    multiple of any group's rows: one launch a call, byte-equal to its
    plain version and to the rows read on the host."""
    gen = torch.Generator().manual_seed(d)
    n = 97
    big = (torch.randn(n * d + 1, generator=gen) * 100).to(dtype)
    for m in (1, 31, 33, 8 * 32 + 5):
        idx = _b1_ids(gen, n, m)
        for shift in (0, 1):
            flat_cpu = big[shift:shift + n * d]
            flat = big.to(cuda_device)[shift:shift + n * d]
            table = flat.view(n, d)
            want = flat_cpu.view(n, d)[idx.long()]
            before = LAUNCHES["gather_rows"]
            got = gops.gather_plan_rows(flat, idx.numpy() * d, d)
            assert LAUNCHES["gather_rows"] == before + 1
            assert _bytes_equal(got.cpu(), want), (m, shift)
            assert _bytes_equal(got, gref.gather_rows(table,
                                                      idx.to(cuda_device)))


@pytest.mark.parametrize("d", (1, 3, 250, 256))
def test_gather_rows_into_a_misaligned_output(cuda_device, d):
    """The C entry with an output one element off 16-byte alignment and
    the layout ``rows_layout`` gives for it: byte-equal to the plain
    version, the bytes around the output untouched."""
    from repro_torch.kernels import _build

    gen = torch.Generator().manual_seed(11)
    table = torch.randn(300, d, generator=gen).to(cuda_device)
    idx = _b1_ids(gen, 300, 333).to(cuda_device)
    big = torch.full((333 * d + 2,), -7.0, device=cuda_device)
    out = big[1:1 + 333 * d]
    layout = gk.rows_layout(d, 4, 333, table.data_ptr(), out.data_ptr())
    assert layout[0] == 4
    lib = _build.library("gather")
    status = lib.polytope_gather_rows(
        cuda_device.index or 0, table.data_ptr(), d, idx.data_ptr(), 333, 4,
        *layout, out.data_ptr(), _build.stream_of(cuda_device))
    _build.check(lib, status, "gather_rows")
    assert _bytes_equal(out.view(333, d), gref.gather_rows(table, idx))
    assert float(big[0]) == float(big[-1]) == -7.0


def test_gather_rows_output_past_2_31_elements(cuda_device):
    """An output of 2^31 + 6,144 uint8 elements (2.1 GB; D = 2048, M =
    2^20 + 3): its last rows land past 2^31 and must not wrap."""
    gen = torch.Generator().manual_seed(12)
    n, d, m = 4096, 2048, (1 << 20) + 3
    table = torch.randint(0, 256, (n, d), generator=gen,
                          dtype=torch.uint8).to(cuda_device)
    idx = _b1_ids(gen, n, m).to(cuda_device)
    before = LAUNCHES["gather_rows"]
    got = gk.gather_rows(table, idx)
    assert LAUNCHES["gather_rows"] == before + 1
    assert got.numel() > 2 ** 31
    assert _bytes_equal(got[-4:], table[idx[-4:].long()])
    assert _bytes_equal(got, gref.gather_rows(table, idx))


def test_gather_rows_refuses_another_layout(cuda_device, monkeypatch):
    """A layout other than the rule's is refused by the C entry and the
    wrapper raises, with no launch counted: a pack wider than the table's
    alignment, one narrower than the widest, a group other than the
    rule's, and rows a group outside 1, 2, 4, 8."""
    big = torch.zeros(65 * 256 + 1, device=cuda_device)
    idx = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    aligned = big[:64 * 256].view(64, 256)
    shifted = big[1:1 + 64 * 256].view(64, 256)
    assert gk.gather_rows(aligned, idx).shape == (5, 256)
    before = LAUNCHES["gather_rows"]
    for table, layout in ((shifted, (16, 32, 4)), (aligned, (8, 32, 4)),
                          (aligned, (16, 16, 4)), (aligned, (16, 32, 3))):
        monkeypatch.setattr(gk, "rows_layout", lambda *a: layout)
        with pytest.raises(RuntimeError, match="gather_rows"):
            gk.gather_rows(table, idx)
    assert LAUNCHES["gather_rows"] == before


def _edge_runs(n, seed):
    """Runs that are empty, of length 1, ending at the payload's last
    element, longer than 128, adjacent, at odd offsets (so that source
    and output are not congruent mod 16), and short ones anywhere."""
    rng = np.random.default_rng(seed)
    starts = [0, 10, n - 300, 100, 1201, 1718, 3, n - 1]
    lengths = [0, 1, 300, 1000, 517, 40, 0, 1]
    for _ in range(200):
        ln = int(rng.integers(1, 60))
        starts.append(int(rng.integers(0, n - ln)))
        lengths.append(ln)
    return np.asarray(starts), np.asarray(lengths)


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.int16, torch.uint8))
@pytest.mark.parametrize("shift", (0, 1, 3))
def test_gather_plan_runs(cuda_device, dtype, shift):
    """B2 on a payload view shifted by ``shift`` elements: one launch a
    call, byte-equal to its plain version and to the runs read on the
    host."""
    gen = torch.Generator().manual_seed(5)
    full = (torch.randn(5003, generator=gen) * 100).to(dtype)
    flat_cpu = full[shift:shift + 5000]
    flat = full.to(cuda_device)[shift:shift + 5000]
    starts, lengths = _edge_runs(5000, seed=shift)
    args = gops.plan_run_inputs(flat, starts, lengths)
    before = LAUNCHES["gather_plan_runs"]
    got = gk.gather_plan_runs(flat, *args)
    assert LAUNCHES["gather_plan_runs"] == before + 1
    assert _bytes_equal(got, gref.gather_plan_runs(flat, *args))
    want = torch.cat([flat_cpu[s:s + ln] for s, ln in zip(starts, lengths)])
    assert _bytes_equal(got.cpu(), want)
    assert _bytes_equal(gops.gather_plan_runs(flat, starts, lengths).cpu(),
                        want)
    assert LAUNCHES["gather_plan_runs"] == before + 2


def test_gather_union_slices(cuda_device, iwc):
    """A window of overlapping plans (Germany twice, over all levels, and
    the UK): one launch, byte-equal to its plain version and to each
    plan's offsets read on the host."""
    data = iwc.field_data(seed=6)
    flat = torch.from_numpy(data).to(cuda_device)
    slicer = Slicer(iwc.cube)
    reqs = _requests(iwc)
    plans = [slicer.extract_plan(reqs[k])[0]
             for k in ("germany", "all_levels", "uk", "germany")]
    union = np.unique(np.concatenate([p.offsets for p in plans]))
    positions = np.concatenate([np.searchsorted(union, p.offsets)
                                for p in plans])
    args = gops.union_slice_inputs(flat, union, positions)
    before = LAUNCHES["gather_union_slices"]
    got = gk.gather_union_slices(flat, *args)
    assert LAUNCHES["gather_union_slices"] == before + 1
    assert _bytes_equal(got, gref.gather_union_slices(flat, *args))
    want = np.concatenate([data[p.offsets] for p in plans])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    table = torch.zeros(8, 2, device=cuda_device)
    with pytest.raises(TypeError):
        gk.gather_rows(table, torch.zeros(3, dtype=torch.int64,
                                          device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        gk.gather_rows(table.t(), torch.zeros(3, dtype=torch.int32,
                                              device=cuda_device))
    flat = torch.zeros(8, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(2, **i32)
    offsets = torch.arange(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        gk.gather_plan_runs(flat, torch.zeros(2, dtype=torch.int64,
                                              device=cuda_device),
                            lengths, offsets, 2)
    with pytest.raises(TypeError):
        gk.gather_plan_runs(flat, torch.zeros(2, **i32), lengths,
                            offsets.int(), 2)
    with pytest.raises(ValueError):
        gk.gather_plan_runs(flat, torch.zeros(2, dtype=torch.int32),
                            lengths, offsets, 2)          # CPU starts
    with pytest.raises(ValueError):
        gk.gather_plan_runs(flat.cpu(), torch.zeros(2, **i32), lengths,
                            offsets, 2)                   # CPU payload
    with pytest.raises(TypeError):
        gk.gather_union_slices(flat, torch.zeros(2, dtype=torch.int64,
                                                 device=cuda_device),
                               torch.zeros(2, **i32))
    with pytest.raises(ValueError):
        gk.gather_union_slices(flat, torch.zeros(2, **i32),
                               torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gk.gather_union_slices(flat.cpu(), torch.zeros(2, **i32),
                               torch.zeros(2, **i32))


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


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("jobs,max_rows,kind",
                         PLAN_SCAN_CASES + [(3552, 24, "seam")])
def test_plan_runs_2d_scan(cuda_device, jobs, max_rows, kind, dtype):
    """The one-launch kernel (a warp per job, a look-back scan over
    tiles of jobs) at the shapes that stress its order, and at the
    all-levels request's job count: full buffers and meta byte-equal to
    the plain version on the card and on the CPU."""
    args, kw = plan_scan_case(jobs, max_rows, kind, seed=jobs + max_rows,
                              dtype=dtype)
    cpu = [torch.from_numpy(a) for a in args]
    tensors = [t.to(cuda_device) for t in cpu]
    before = LAUNCHES["plan_runs_2d"]
    got = pk.plan_runs_2d(*tensors, **kw)
    assert LAUNCHES["plan_runs_2d"] == before + 1
    want = pref.plan_runs_2d(*tensors, **kw)
    for a, b, c in zip(got, want, pref.plan_runs_2d(*cpu, **kw)):
        assert _bytes_equal(a, b) and _bytes_equal(a.cpu(), c)
    assert (int(got[2][0]) == 0) == (kind == "none")


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
        assert LAUNCHES["gather_plan_runs"] == \
            before["gather_plan_runs"] + 1, name
        assert LAUNCHES["gather_rows"] == before["gather_rows"], name
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
    before = dict(LAUNCHES)
    results = svc.submit_batch(reqs + reqs[:2], flat)
    assert LAUNCHES["gather_union_slices"] == \
        before["gather_union_slices"] + 1
    assert LAUNCHES["gather_rows"] == before["gather_rows"]
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


# -- B5, B4 on its own and the batched crop planner ---------------------------

def _slice_inputs(p, v, d, k, seed):
    """Random layers with on-plane vertices and padded slots: the plane
    of every third polytope passes through one of its vertices."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-50, 50, (p, v, d)).astype(np.float32)
    nvalid = rng.integers(2, v + 1, p)
    valid = np.arange(v)[None, :] < nvalid[:, None]
    planes = rng.uniform(-40, 40, p).astype(np.float32)
    planes[::3] = verts[::3, 0, k]
    return verts, valid, planes


@pytest.mark.parametrize("p,v,d,k", [(4, 6, 3, 0), (10, 8, 4, 2),
                                     (1, 4, 2, 1), (9, 12, 5, 4),
                                     (1000, 3, 2, 0), (37, 32, 8, 7),
                                     (959, 4, 2, 0), (50, 5, 1, 0),
                                     (17, 32, 3, 1), (64, 7, 4, 3),
                                     (300, 9, 6, 5), (3, 32, 400, 17)])
def test_slice_batch(cuda_device, p, v, d, k):
    """Over D = 1 (scalar stores), 2 and 6 (float2), 3 and 5 (scalars),
    4 and 8 (float4), V up to 32, and V x D = 12,800 (past the 48 KB
    that the former shared-memory kernel refused)."""
    tens = [torch.from_numpy(a).to(cuda_device)
            for a in _slice_inputs(p, v, d, k, seed=p + v + d + k)]
    before = LAUNCHES["slice_batch"]
    got = sk.slice_batch(*tens, k)
    assert LAUNCHES["slice_batch"] == before + 1
    want = sref.slice_batch(*tens, k)
    for a, b in zip(got, want):
        assert _bytes_equal(a, b), (p, v, d, k)
    assert bool(got[1].any())


def test_slice_batch_refuses_what_it_does_not_take(cuda_device):
    verts, valid, planes = (torch.from_numpy(a) for a in
                            _slice_inputs(4, 3, 2, 0, seed=0))
    with pytest.raises(TypeError):
        sk.slice_batch(verts.double().to(cuda_device),
                       valid.to(cuda_device),
                       planes.double().to(cuda_device), 0)
    with pytest.raises(ValueError):
        sk.slice_batch(verts, valid, planes, 0)          # CPU tensors
    with pytest.raises(ValueError):
        sk.slice_batch(verts.to(cuda_device), valid.to(cuda_device),
                       planes.to(cuda_device), 2)        # k outside D


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("b,v,r", [(256, 3, 40), (7, 16, 5), (1, 1, 3)])
def test_slice_minor_extents(cuda_device, dtype, b, v, r):
    rng = np.random.default_rng(b * v + r)
    xy = rng.uniform(-20, 20, (2, b, v))
    valid = np.arange(v)[None, :] < rng.integers(1, v + 1, b)[:, None]
    planes = rng.uniform(-20, 20, (b, r))
    planes[:, 0] = xy[0, :, 0]                           # on-plane hits
    tol = 1e-6 * np.maximum(1.0, np.abs(xy[0]).max(1))
    x, y, pl, tl = (torch.from_numpy(np.ascontiguousarray(a)).to(
        cuda_device, dtype) for a in (xy[0], xy[1], planes, tol))
    vm = torch.from_numpy(valid).to(cuda_device)
    before = LAUNCHES["slice_minor_extents"]
    got = sk.slice_minor_extents(x, y, vm, pl, tl)
    assert LAUNCHES["slice_minor_extents"] == before + 1
    want = sref.slice_minor_extents(x[:, None, :], y[:, None, :],
                                    vm[:, None, :], pl, tl[:, None])
    for a, w in zip(got, want):
        assert _bytes_equal(a, w), (b, v, r)


def test_batched_paths_on_the_card(cuda_device):
    """Each entry point against its plain version; the lattice and the
    extract are one launch of the batched crop planner each, with no
    launch of B4 on its own or of B1."""
    from repro_torch.core import batched
    from repro_torch.core.geometry import Polytope
    from repro_torch.kernels.slice import ops as sops

    rng = np.random.default_rng(3)
    polys = [Polytope(("a", "b"), rng.uniform(0, 60, (rng.integers(3, 7),
                                                       2)))
             for _ in range(64)]
    axis0 = np.arange(64.0, dtype=np.float32)
    axis1 = np.arange(80.0, dtype=np.float32)
    field = torch.from_numpy(rng.normal(size=64 * 80).astype(np.float32))
    on_card, on_cpu = {}, {}
    for dev, out in ((cuda_device, on_card), ("cpu", on_cpu)):
        verts, valid = sops.pack_polytopes(polys, v_max=8, device=dev)
        for what, call in (
                ("lattice", lambda: batched.batched_plan_2d(
                    verts, valid, axis0, axis1, 64, 80, 64, 64,
                    device=dev)),
                ("runs", lambda: batched.batched_plan_runs_2d(
                    verts, valid, axis0, axis1, 64, device=dev)),
                ("extract", lambda: batched.batched_extract_2d(
                    field.to(dev), verts, valid, axis0, axis1, 64, 64,
                    device=dev))):
            before = dict(LAUNCHES)
            out[what] = call()
            if dev == cuda_device:
                moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}
                assert moved == ({"plan_runs_2d": 1} if what == "runs"
                                 else {"batched_plan_2d": 1}), (what, moved)
    for what in on_cpu:
        for a, b in zip(on_card[what], on_cpu[what]):
            assert a.is_cuda and _bytes_equal(a.cpu(), b), what


def _card(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_plan_2d_on_the_edges(cuda_device, case):
    """The lattice's edges of tests/torch_batched_cases.py, the plan and
    the read (float32 field), kernel against plain version on the card."""
    (verts, valid), rows, cols = BATCHED_CASES[case]
    tens = _card(cuda_device, verts, valid, BATCHED_AXIS0, BATCHED_AXIS1)
    n0, n1 = BATCHED_AXIS0.size, BATCHED_AXIS1.size
    field = torch.from_numpy(np.random.default_rng(1).normal(
        size=n0 * n1).astype(np.float32)).to(cuda_device)
    for f in (None, field):
        before = LAUNCHES["batched_plan_2d"]
        got = sk.batched_plan_2d(*tens, n0, n1, rows, cols, f)
        assert LAUNCHES["batched_plan_2d"] == before + 1
        want = sref.batched_plan_2d(*tens, n0, n1, rows, cols, f)
        for a, b in zip(got, want):
            assert (a is None and b is None) or _bytes_equal(a, b), case


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("seed", range(3))
def test_batched_plan_2d_random_layers(cuda_device, seed, dtype):
    """Seeded random layers in float32 and in float64 (vertices and
    axes), over a grid smaller than the axes (n0 < len(axis0))."""
    verts, valid = batched_random_layer(seed, p=200, dtype=dtype)
    tens = _card(cuda_device, verts, valid, BATCHED_AXIS0.astype(dtype),
                 BATCHED_AXIS1.astype(dtype))
    for n0, n1, rows, cols in ((16, 24, 12, 16), (14, 20, 9, 40),
                               (16, 24, 17, 9)):
        got = sk.batched_plan_2d(*tens, n0, n1, rows, cols)
        want = sref.batched_plan_2d(*tens, n0, n1, rows, cols)
        for a, b in zip(got[:2], want[:2]):
            assert _bytes_equal(a, b), (seed, n0, n1, rows, cols)
        assert int(got[1].sum()) > 0


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_batched_plan_2d_axes_past_shared_memory(cuda_device, dtype):
    """Axes of more than the 48 KB a block stages in shared memory are
    read where they lie; the plan and the read are the same."""
    verts, valid = batched_random_layer(4, p=100, dtype=dtype)
    axis1 = (np.arange(13_000) * 0.5).astype(dtype)      # 52 KB or more
    tens = _card(cuda_device, verts, valid, BATCHED_AXIS0.astype(dtype),
                 axis1)
    n0 = BATCHED_AXIS0.size
    for n1 in (24, axis1.size):
        field = torch.arange(n0 * n1, dtype=torch.float32,
                             device=cuda_device)
        got = sk.batched_plan_2d(*tens, n0, n1, 12, 40, field)
        want = sref.batched_plan_2d(*tens, n0, n1, 12, 40, field)
        for a, b in zip(got, want):
            assert _bytes_equal(a, b), (dtype, n1)
        assert int(got[1].sum()) > 0


@pytest.mark.parametrize("dtype,len0,len1", [
    (np.float32, 4096, 8184),     # 48 KB less the warps' counts: staged
    (np.float32, 4096, 8185),     # 4 bytes more: read where they lie
    (np.float32, 4096, 8192),     # F2048's axes, exactly 48 KB
    (np.float64, 2048, 4096),     # F1024's in float64, exactly 48 KB
])
def test_batched_plan_2d_axes_at_the_shared_memory_edge(cuda_device, dtype,
                                                        len0, len1):
    """Axes at the edge of the 48 KB a block gets without opting in,
    where the per-warp counts share it with the staged axes: every launch
    is taken, and the plan and the read are byte-equal to the plain
    version."""
    verts, valid = batched_random_layer(5, p=100, dtype=dtype)
    axis0 = np.linspace(-10, 10, len0).astype(dtype)
    axis1 = np.linspace(-5, 17, len1).astype(dtype)
    tens = _card(cuda_device, verts, valid, axis0, axis1)
    field = torch.arange(len0 * len1, dtype=torch.int32, device=cuda_device)
    got = sk.batched_plan_2d(*tens, len0, len1, 48, 64, field)
    want = sref.batched_plan_2d(*tens, len0, len1, 48, 64, field)
    for a, b in zip(got, want):
        assert _bytes_equal(a, b), (dtype, len0, len1)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.bfloat16, torch.int16,
                                   torch.uint8, torch.bool))
def test_batched_plan_2d_reads_every_word_width(cuda_device, dtype):
    """The read moves 8-, 4-, 2- and 1-byte words: live values copied bit
    for bit, padded slots all-zero bytes (+0.0)."""
    verts, valid = batched_random_layer(7, p=64)
    tens = _card(cuda_device, verts, valid, BATCHED_AXIS0, BATCHED_AXIS1)
    n0, n1 = BATCHED_AXIS0.size, BATCHED_AXIS1.size
    gen = torch.Generator().manual_seed(0)
    field = (torch.randn(n0 * n1, generator=gen) * 50).to(dtype)
    field = field.to(cuda_device)
    got = sk.batched_plan_2d(*tens, n0, n1, 12, 16, field)
    want = sref.batched_plan_2d(*tens, n0, n1, 12, 16, field)
    for a, b in zip(got, want):
        assert _bytes_equal(a, b), dtype


def test_batched_extract_2d_bool_field_gives_int32(cuda_device):
    """A bool field's values, read as 1-byte words on the card, come back
    as int32, as on the CPU and in the JAX package (ROADMAP C10)."""
    from repro_torch.core import batched

    verts, valid = batched_random_layer(3, p=64)
    n0, n1 = BATCHED_AXIS0.size, BATCHED_AXIS1.size
    gen = torch.Generator().manual_seed(1)
    field = torch.randint(0, 2, (n0 * n1,), generator=gen).bool()
    got = batched.batched_extract_2d(field.to(cuda_device), verts, valid,
                                     BATCHED_AXIS0, BATCHED_AXIS1, 12, 16,
                                     device=cuda_device)
    want = batched.batched_extract_2d(field, verts, valid, BATCHED_AXIS0,
                                      BATCHED_AXIS1, 12, 16, device="cpu")
    assert got[0].dtype == want[0].dtype == torch.int32
    assert int(got[0].sum()) > 0
    for a, b in zip(got, want):
        assert _bytes_equal(a.cpu(), b)


def test_batched_entry_points_make_no_host_sync(cuda_device):
    """With numpy axes (one pinned copy) and card tensors, neither entry
    point synchronises with the host."""
    from repro_torch.core import batched

    verts, valid = batched_random_layer(2, p=128)
    verts, valid = _card(cuda_device, verts, valid)
    n0, n1 = BATCHED_AXIS0.size, BATCHED_AXIS1.size
    field = torch.arange(n0 * n1, dtype=torch.float32, device=cuda_device)

    def both():
        plan = batched.batched_plan_2d(verts, valid, BATCHED_AXIS0,
                                       BATCHED_AXIS1, n0, n1, 12, 16,
                                       device=cuda_device)
        return plan, batched.batched_extract_2d(
            field, verts, valid, BATCHED_AXIS0, BATCHED_AXIS1, 12, 16,
            device=cuda_device)

    both()                                  # builds the kernels
    torch.cuda.synchronize()
    before = LAUNCHES["batched_plan_2d"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan, extract = both()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES["batched_plan_2d"] == before + 2
    for a, b in zip(plan, extract[1:]):
        assert torch.equal(a, b)


def test_batched_plan_2d_refuses_what_it_does_not_take(cuda_device):
    verts, valid = batched_random_layer(0, p=4)
    tens = _card(cuda_device, verts, valid, BATCHED_AXIS0, BATCHED_AXIS1)
    n0, n1 = BATCHED_AXIS0.size, BATCHED_AXIS1.size
    with pytest.raises(TypeError):                   # mixed dtypes
        sk.batched_plan_2d(tens[0], tens[1], tens[2].double(), tens[3], n0,
                           n1, 4, 4)
    with pytest.raises(ValueError, match="outside the axes"):
        sk.batched_plan_2d(*tens, n0 + 1, n1, 4, 4)
    with pytest.raises(IndexError, match="field of"):
        sk.batched_plan_2d(*tens, n0, n1, 4, 4,
                           torch.zeros(n0 * n1 - 1, device=cuda_device))
    with pytest.raises(TypeError, match="16 bytes"):
        sk.batched_plan_2d(*tens, n0, n1, 4, 4, torch.zeros(
            n0 * n1, dtype=torch.complex128, device=cuda_device))
    with pytest.raises(IndexError, match="grid of"):
        from repro_torch.core import batched
        batched.batched_extract_2d(
            torch.zeros(n0 * n1 - 1, device=cuda_device), tens[0], tens[1],
            BATCHED_AXIS0, BATCHED_AXIS1, 4, 4, device=cuda_device)


def test_sharded_service_on_the_card(cuda_device, iwc):
    from repro_torch.serve import AdmissionQueue, ShardedExtractionService

    data = iwc.field_data(seed=6)
    flat = torch.from_numpy(data).to(cuda_device)
    svc = ShardedExtractionService(iwc.cube, shards=3)
    reqs = list(_requests(iwc).values())
    before = dict(LAUNCHES)
    with AdmissionQueue(svc, flat_data=flat, window_s=60.0,
                        max_batch=len(reqs) + 2) as queue:
        futs = [queue.submit(r) for r in reqs + reqs[:2]]
        results = [f.result(timeout=120) for f in futs]
        adm = queue.snapshot()
    assert adm.windows == 1 and adm.coalesced == 2
    # The window's union read and all its slices: one launch, no B1.
    assert LAUNCHES["gather_union_slices"] == \
        before["gather_union_slices"] + 1
    assert LAUNCHES["gather_rows"] == before["gather_rows"]
    for res in results:
        assert res.values.is_cuda
        np.testing.assert_array_equal(res.values.cpu().numpy(),
                                      data[res.plan.offsets])


def test_launcher_on_the_card(cuda_device, tmp_path):
    from repro_torch.core import PolytopeExtractor
    from repro_torch.launch import serve

    out = tmp_path / "bench.json"
    before = dict(LAUNCHES)
    run = serve.run_extract(serve.parse_args([
        "--mode", "extract", "--grid-n", "32", "--requests", "64",
        "--threads", "4", "--bench-out", str(out)]))
    assert LAUNCHES["gather_union_slices"] > before["gather_union_slices"]
    assert LAUNCHES["gather_rows"] == before["gather_rows"]
    assert run.payload.is_cuda and out.exists()
    fresh = PolytopeExtractor(run.weather.cube)
    for rank, res in run.served:
        want = fresh.extract(run.population[rank], run.payload).values
        assert _bytes_equal(res.values, want), rank


# -- B6 and the recsys models ----------------------------------------------------

def _b6_launched(fn):
    """Run ``fn`` and return its result and the name of the one B6 kernel
    it launched."""
    names = ("gather_rows_bag", "gather_rows_bag_tiled")
    before = {n: LAUNCHES[n] for n in names}
    out = fn()
    ran = [n for n in names if LAUNCHES[n] != before[n]]
    assert len(ran) == 1 and LAUNCHES[ran[0]] == before[ran[0]] + 1, ran
    return out, ran[0]


def _b6_kernel(d: int, dtype) -> str:
    """The B6 kernel a row of ``d`` elements takes: the tiled one below
    the wrapper's ``NARROW_ROW_BYTES``."""
    size = torch.tensor([], dtype=dtype).element_size()
    narrow = d * size < gk.NARROW_ROW_BYTES
    return "gather_rows_bag_tiled" if narrow else "gather_rows_bag"


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("l", (1, 8, 32))
@pytest.mark.parametrize("d", (1, 10, 64, 65))
def test_gather_rows_bag(cuda_device, d, l, dtype):
    gen = torch.Generator().manual_seed(100 * d + l)
    table = torch.randn(1000, d, generator=gen).to(dtype)
    bags = torch.randint(-1, 1000, (777, l), generator=gen,
                         dtype=torch.int32)
    bags[0] = -1                                  # an all-padding bag
    bags[1, 0] = 999
    table, bags = table.to(cuda_device), bags.to(cuda_device)
    got, ran = _b6_launched(lambda: gk.gather_rows_bag(table, bags))
    assert ran == _b6_kernel(d, dtype)
    assert _bytes_equal(got, gref.gather_rows_bag(table, bags))
    assert not bool(got[0].any())


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("shift", (0, 1, 2))
@pytest.mark.parametrize("l", (1, 3, 8))
@pytest.mark.parametrize("d", (1, 2, 3, 10, 64))
def test_gather_rows_bag_tiled(cuda_device, d, l, shift, dtype):
    """B6 at narrow and wide rows, on table views ``shift`` elements past
    an aligned start (so packs of 4, 2 and 1 elements all run), with -1
    slots, a -0.0 row and B not a multiple of any tile: byte-equal to the
    plain version, through the kernel the row's width names."""
    gen = torch.Generator().manual_seed(1000 * d + 10 * l + shift)
    n, b = 500, 77 * 32 + 13
    flat = torch.randn(n * d + shift, generator=gen).to(dtype)
    flat[shift:shift + d] = -0.0                  # row 0 is -0.0
    table = flat.to(cuda_device)[shift:].view(n, d)
    bags = torch.randint(-1, n, (b, l), generator=gen, dtype=torch.int32)
    bags[5] = 0                                   # -0.0 + ... in l order
    bags[6] = -1
    bags = bags.to(cuda_device)
    got, ran = _b6_launched(lambda: gk.gather_rows_bag(table, bags))
    assert ran == _b6_kernel(d, dtype)
    assert _bytes_equal(got, gref.gather_rows_bag(table, bags))
    assert _bytes_equal(got.cpu(), gref.gather_rows_bag(table.cpu(),
                                                        bags.cpu()))


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_gather_rows_bag_entries_refuse_each_others_rows(cuda_device, dtype):
    """Each B6 entry point takes the rows on its side of the wrapper's
    ``NARROW_ROW_BYTES`` and refuses the other's: the C side's boundary
    is the wrapper's."""
    from repro_torch.kernels import _build

    lib = _build.library("gather")
    size = torch.tensor([], dtype=dtype).element_size()
    last_narrow = gk.NARROW_ROW_BYTES // size - 1
    bags = torch.zeros((4, 1), dtype=torch.int32, device=cuda_device)
    for d in (last_narrow, last_narrow + 1):
        table = torch.ones(2, d, dtype=dtype, device=cuda_device)
        out = torch.empty(4, d, dtype=dtype, device=cuda_device)
        status = {entry: getattr(lib, entry)(
            cuda_device.index or 0, table.data_ptr(), d, bags.data_ptr(), 4,
            1, size, out.data_ptr(), _build.stream_of(cuda_device))
            for entry in ("polytope_gather_rows_bag_tiled",
                          "polytope_gather_rows_bag")}
        torch.cuda.synchronize()
        narrow = d == last_narrow
        assert (status["polytope_gather_rows_bag_tiled"] == 0) == narrow
        assert (status["polytope_gather_rows_bag"] == 0) == (not narrow)
        assert bool((out == 1).all()), d


def test_gather_rows_bag_empty_batch_and_view(cuda_device):
    table = torch.randn(100, 64, device=cuda_device)
    empty = gk.gather_rows_bag(table, torch.zeros(
        (0, 4), dtype=torch.int32, device=cuda_device))
    assert empty.shape == (0, 64)
    # A table view 4 bytes past an aligned start takes the scalar path.
    shifted = torch.randn(100 * 64 + 1, device=cuda_device)[1:].view(100, 64)
    bags = torch.randint(-1, 100, (50, 3), dtype=torch.int32,
                         device=cuda_device)
    assert _bytes_equal(gk.gather_rows_bag(shifted, bags),
                        gref.gather_rows_bag(shifted, bags))


@pytest.mark.parametrize("dtype", (torch.float16, torch.bfloat16,
                                   torch.int32))
def test_gather_rows_bag_refuses_other_dtypes(cuda_device, dtype):
    table = torch.zeros(8, 4, device=cuda_device).to(dtype)
    bags = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        gk.gather_rows_bag(table, bags)


def test_dlrm_on_the_card_equals_plain_bag(cuda_device, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.dataplane.recsys import ClickStream
    from repro_torch.models.recsys import DLRM

    cfg = get_config("dlrm-rm2", smoke=True)
    model = DLRM(cfg, device=cuda_device, seed=3)
    batch = ClickStream(n_sparse=cfg.n_sparse, rows=cfg.rows).batch(0, 256)
    dense = torch.from_numpy(batch["dense"]).to(cuda_device)
    bags = torch.from_numpy(batch["bags"]).to(cuda_device)
    with torch.no_grad():
        got, ran = _b6_launched(lambda: model(dense, bags))
        assert ran == _b6_kernel(cfg.embed_dim, torch.float32)
        monkeypatch.setattr(gk, "gather_rows_bag", gref.gather_rows_bag)
        want = model(dense, bags)
    assert got.is_cuda and got.shape == (256,)
    assert _bytes_equal(got, want)


# -- training: B1's and B6's backward, a train step, checkpoints ------------------

@contextlib.contextmanager
def _deterministic():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _grad_on(table, fn, device):
    """The gradient of sum(fn(table) * w) with respect to ``table`` on
    ``device``, w seeded."""
    t = table.to(device).requires_grad_(True)
    out = fn(t)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(5),
                    dtype=out.dtype).to(device)
    (out * w).sum().backward()
    return t.grad


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("l", (1, 3))
@pytest.mark.parametrize("d", (1, 10, 64))
def test_gather_rows_bag_backward_equals_cpu(cuda_device, d, l, dtype):
    """B6's backward on the card (B6 in the forward) byte-equal to the
    plain backward on the CPU, in deterministic mode: repeated ids, -1
    slots and a bag of padding only."""
    gen = torch.Generator().manual_seed(d * 10 + l)
    table = torch.randn(500, d, generator=gen).to(dtype)
    bags = torch.randint(-1, 40, (4096, l), generator=gen,
                         dtype=torch.int32)       # 40 hot rows, repeated
    bags[0] = -1
    with _deterministic():
        got = _grad_on(table, lambda t: gops.gather_rows_bag(
            t, bags.to(cuda_device)), cuda_device)
    want = _grad_on(table, lambda t: gops.gather_rows_bag(t, bags), "cpu")
    assert _bytes_equal(got.cpu(), want)


@pytest.mark.parametrize("d", (1, 256))
def test_gather_rows_backward_equals_cpu(cuda_device, d):
    gen = torch.Generator().manual_seed(d)
    table = torch.randn(300, d, generator=gen)
    idx = torch.randint(0, 30, (8192,), generator=gen, dtype=torch.int32)
    with _deterministic():
        got = _grad_on(table, lambda t: gops.gather_rows(
            t, idx.to(cuda_device)), cuda_device)
    want = _grad_on(table, lambda t: gops.gather_rows(t, idx), "cpu")
    assert _bytes_equal(got.cpu(), want)


# A DLRM smoke step on the card against the same step on the CPU: the
# loss and the updated state within rtol = 1e-5, atol = 1e-6 (cuBLAS and
# the CPU order float32 sums their own ways; TF32 stays off).
CARD_STEP = dict(rtol=1e-5, atol=1e-6)


def test_dlrm_smoke_step_on_the_card_equals_cpu(cuda_device):
    from repro_torch.configs import train as train_cfgs
    from repro_torch.dataplane.pipeline import device_put
    from repro_torch.train.checkpoint import flatten_tree

    assert not torch.backends.cuda.matmul.allow_tf32
    setups = {dev: train_cfgs.smoke("dlrm-rm2", device=dev, seed=2)
              for dev in ("cpu", cuda_device)}
    with torch.no_grad():       # the CPU's weights on the card
        for k, p in setups[cuda_device]["state"]["params"].items():
            p.copy_(setups["cpu"]["state"]["params"][k])
    runs = {}
    for dev, s in setups.items():
        before = dict(LAUNCHES)
        state, metrics = s["step"](s["state"], device_put(s["batch"], dev))
        runs[str(dev)] = (flatten_tree(state), metrics,
                          LAUNCHES["gather_rows_bag"]
                          - before["gather_rows_bag"]
                          + LAUNCHES["gather_rows_bag_tiled"]
                          - before["gather_rows_bag_tiled"])
    (want, wm, n_cpu), (got, gm, n_card) = runs["cpu"], runs[str(cuda_device)]
    assert (n_cpu, n_card) == (0, 1)          # one B6 launch on the card
    for k in wm:
        torch.testing.assert_close(gm[k].cpu(), wm[k], **CARD_STEP)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k].detach().cpu(), v.detach(),
                                   **CARD_STEP, msg=k)


def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    from repro_torch.configs import train as train_cfgs
    from repro_torch.dataplane.pipeline import device_put
    from repro_torch.train import checkpoint as ckpt

    s = train_cfgs.smoke("deepfm", device=cuda_device)
    state, _ = s["step"](s["state"], device_put(s["batch"], cuda_device))
    thread = ckpt.save_checkpoint(tmp_path, 0, state, blocking=False)
    snap = {k: v.detach().clone() for k, v in ckpt.flatten_tree(
        state).items()}
    state, _ = s["step"](state, device_put(s["batch"], cuda_device))
    thread.join()
    fresh = train_cfgs.smoke("deepfm", device=cuda_device, seed=1)["state"]
    ckpt.restore_checkpoint(tmp_path, 0, fresh)
    for k, v in ckpt.flatten_tree(fresh).items():
        assert v.is_cuda and _bytes_equal(v.detach().reshape(-1),
                                          snap[k].reshape(-1)), k


# -- B7 and NequIP ----------------------------------------------------------------

def _segment_case(e, s, d, dtype, seed, hub=10_000):
    """(e, d) messages and ids in [-1, s): segment 7 a hub of ``hub``
    edges, segment 11 empty."""
    gen = torch.Generator().manual_seed(seed)
    msg = torch.randn(e, d, generator=gen).to(dtype)
    ids = torch.randint(-1, s, (e,), generator=gen, dtype=torch.int32)
    ids[ids == 7] = 8
    ids[torch.randperm(e, generator=gen)[:hub]] = 7
    ids[ids == 11] = 12
    return msg, ids


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("d", (1, 10, 32, 160))
def test_segment_sum(cuda_device, d, dtype):
    msg, ids = _segment_case(30_000, 3000, d, dtype, seed=d)
    want_cpu = segref.segment_sum(msg, ids, 3000)
    msg, ids = msg.to(cuda_device), ids.to(cuda_device)
    before = LAUNCHES["segment_sum"]
    got = segk.segment_sum(msg, ids, 3000)
    assert LAUNCHES["segment_sum"] == before + 1
    assert _bytes_equal(got, segref.segment_sum(msg, ids, 3000))
    assert _bytes_equal(got.cpu(), want_cpu)
    assert not bool(got[11].any())
    assert int((ids == 7).sum()) == 10_000


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("d", (1, 32, 160))
def test_segment_sum_with_a_plan(cuda_device, d, dtype):
    """One plan built on the card (one segment_plan count), read by B7
    on three message tensors: each byte-equal to the ids path and to the
    plain version on the CPU."""
    msg, ids = _segment_case(30_000, 3000, d, dtype, seed=d + 1)
    ids = ids.to(cuda_device)
    before = dict(LAUNCHES)
    plan = segops.segment_plan(ids, 3000)
    assert LAUNCHES["segment_plan"] == before["segment_plan"] + 1
    assert plan.perm.is_cuda and plan.offsets.is_cuda
    for scale in (1.0, -0.5, 3.0):
        m = (msg * scale).to(cuda_device)
        want_cpu = segref.segment_sum(m.cpu(), ids.cpu(), 3000)
        got = segops.segment_sum(m, plan, 3000)
        assert _bytes_equal(got, segk.segment_sum(m, ids, 3000))
        assert _bytes_equal(got.cpu(), want_cpu)
    assert LAUNCHES["segment_sum"] == before["segment_sum"] + 6
    assert LAUNCHES["segment_plan"] == before["segment_plan"] + 1
    with pytest.raises(ValueError, match="num_segments"):
        segk.segment_sum(msg.to(cuda_device), plan, 2999)
    with pytest.raises(ValueError, match="plan of"):
        segk.segment_sum(msg[1:].to(cuda_device), plan, 3000)
    with pytest.raises(ValueError, match="plan on"):
        segops.segment_sum(msg, plan, 3000)              # CPU messages


def test_segment_sum_empty_inputs_and_a_misaligned_view(cuda_device):
    none = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    out = segk.segment_sum(torch.zeros((0, 4), device=cuda_device), none, 5)
    assert out.shape == (5, 4) and not bool(out.any())
    assert segk.segment_sum(torch.zeros((0, 4), device=cuda_device), none,
                            0).shape == (0, 4)
    # Messages 4 bytes past an aligned start take the scalar path.
    msg, ids = _segment_case(2000, 300, 32, torch.float32, seed=1, hub=500)
    shifted = torch.randn(2000 * 32 + 1, device=cuda_device)[1:].view(2000,
                                                                       32)
    shifted.copy_(msg)
    ids = ids.to(cuda_device)
    assert _bytes_equal(segk.segment_sum(shifted, ids, 300),
                        segref.segment_sum(shifted, ids, 300))


def test_segment_sum_refuses_what_it_does_not_take(cuda_device):
    ids = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(TypeError):
            segk.segment_sum(torch.zeros((4, 2), device=cuda_device)
                             .to(dtype), ids, 3)
    with pytest.raises(TypeError):                       # int64 ids
        segk.segment_sum(torch.zeros((4, 2), device=cuda_device),
                         ids.long(), 3)
    with pytest.raises(ValueError):                      # CPU ids
        segk.segment_sum(torch.zeros((4, 2), device=cuda_device),
                         ids.cpu(), 3)
    with pytest.raises(ValueError):                      # CPU messages
        segk.segment_sum(torch.zeros((4, 2)), ids, 3)
    with pytest.raises(ValueError):                      # lengths differ
        segk.segment_sum(torch.zeros((5, 2), device=cuda_device), ids, 3)
    with pytest.raises(IndexError):                      # id past S
        segops.segment_sum(torch.zeros((4, 2), device=cuda_device),
                           ids + 3, 3)


@pytest.mark.parametrize("shape", ("molecule", "full_graph_sm"))
def test_nequip_on_the_card_equals_plain_segment_sum(cuda_device, shape,
                                                     monkeypatch):
    from repro_torch.configs import nequip as nequip_cfg
    from repro_torch.dataplane import graph
    from repro_torch.models.nequip import NequIP, nequip_energy_forces

    cfg = nequip_cfg.for_shape(shape, smoke=True)
    if shape == "molecule":
        b = graph.molecule_batch(8, pad_nodes=256, pad_edges=600)
    else:
        cfg = dataclasses.replace(cfg, d_feat=12)
        b = graph.full_graph_batch(graph.synthetic_graph(200, 4, 12, 7),
                                   256, 1024)
    model = NequIP(cfg, device=cuda_device, seed=3)
    args = [torch.from_numpy(b[k]).to(cuda_device)
            for k in ("node_feat", "positions", "edge_index")]
    kw = {}
    if shape == "molecule":
        gid = torch.from_numpy(b["graph_ids"]).to(cuda_device)
        kw = dict(graph_ids=gid, n_graphs=8)

    def run():
        if shape == "molecule":
            return nequip_energy_forces(model, *args, **kw)
        with torch.no_grad():
            return (model(*args),)

    before = dict(LAUNCHES)
    got = run()
    forces = shape == "molecule"
    # The forward's sums, the energy readout, and the forces' backward
    # of the source gathers of every layer after the first.
    per_forward = 3 * cfg.n_layers + forces + forces * 3 * (cfg.n_layers - 1)
    assert LAUNCHES["segment_sum"] == before["segment_sum"] + per_forward
    # Plans of the destination and the source ids, one more of the graph
    # ids.
    assert LAUNCHES["segment_plan"] == before["segment_plan"] + 2 + forces
    monkeypatch.setattr(segk, "segment_sum", segref.segment_sum)
    want = run()
    for a, w in zip(got, want):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        assert _bytes_equal(a, w)


# -- B8: paged decode attention -----------------------------------------------

def _attn_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


def _attn_case(b, h, kvh, dh, ps, pmax, dtype, seed, lens=None):
    """Inputs on the CPU: each sequence's pages drawn without replacement
    (shuffled ids) from a pool of b * pmax + 3."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = b * pmax + 3
    q = torch.randn((b, h, dh), generator=gen).to(dtype)
    kp = torch.randn((n_pages, kvh, ps, dh), generator=gen).to(dtype)
    vp = torch.randn((n_pages, kvh, ps, dh), generator=gen).to(dtype)
    if lens is None:
        lens = torch.randint(1, ps * pmax + 1, (b,), generator=gen)
    lens = torch.as_tensor(lens, dtype=torch.int32)
    table = torch.full((b, pmax), -1, dtype=torch.int32)
    free = torch.randperm(n_pages, generator=gen).int().tolist()
    for i in range(b):
        for j in range(-(-int(lens[i]) // ps)):
            table[i, j] = free.pop()
    return q, kp, vp, table, lens


def _on(dev, *tensors):
    return [t.to(dev) for t in tensors]


def _b8_kernel(dtype, h, kvh, dh) -> str:
    """The LAUNCHES name of the B8 kernel these inputs take."""
    tc = dtype == torch.bfloat16 and dh in (16, 32, 64, 128) \
        and h // kvh <= 16
    return "paged_decode_attention" if tc else "paged_decode_attention_simt"


def _b8_launched(fn, name):
    """``fn()``, asserting that it launched B8's kernel ``name`` once and
    the other B8 kernel not at all."""
    before = dict(LAUNCHES)
    out = fn()
    for kernel in ("paged_decode_attention", "paged_decode_attention_simt"):
        assert LAUNCHES[kernel] - before[kernel] == (kernel == name), kernel
    return out


def _assert_b8_close(got, want, dtype):
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               **_attn_tol(dtype))
    if dtype == torch.bfloat16:
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * float(want.float().abs().max())


ATTN_SHAPES = [(2, 4, 4, 8, 4, 3), (3, 8, 2, 16, 4, 6), (1, 8, 1, 32, 8, 4),
               (3, 14, 2, 8, 4, 5),                  # the CPU tests' shapes
               (4, 16, 4, 128, 16, 24),              # G = 4 (Granite)
               (3, 56, 8, 128, 16, 20),              # G = 7 (Yi)
               (5, 32, 2, 128, 16, 40)]              # G = 16 (GLM-4)


@pytest.mark.parametrize("n_split", (None, 1, 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=lambda s: "b{}h{}kvh{}dh{}ps{}pmax{}".format(*s))
def test_paged_decode_attention(cuda_device, shape, dtype, n_split):
    case = _attn_case(*shape, dtype, seed=sum(shape))
    want = paref.paged_decode_attention(*case)
    got = _b8_launched(lambda: pak.paged_decode_attention(
        *_on(cuda_device, *case), n_split=n_split),
        _b8_kernel(dtype, *shape[1:4]))
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    _assert_b8_close(got, want, dtype)


@pytest.mark.parametrize("n_split", (None, 1, 3))
@pytest.mark.parametrize("g", (1, 4, 7, 16))
@pytest.mark.parametrize("dh", (64, 128))
def test_paged_decode_attention_tensor_cores(cuda_device, dh, g, n_split):
    """bf16 on the tensor-core kernel: every length ends mid-page (and
    mid-step), one is shorter than a step, the longest spans 41 pages."""
    kvh = 2
    lens = [651, 5, 300, 77]
    case = _attn_case(4, g * kvh, kvh, dh, 16, 41, torch.bfloat16,
                      seed=dh + g, lens=lens)
    want = paref.paged_decode_attention(*case)
    got = _b8_launched(lambda: pak.paged_decode_attention(
        *_on(cuda_device, *case), n_split=n_split), "paged_decode_attention")
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    _assert_b8_close(got, want, torch.bfloat16)
    # The CUDA-core kernel computes the same function on the same inputs.
    simt = _b8_launched(lambda: pak.paged_decode_attention_simt(
        *_on(cuda_device, *case), n_split=n_split),
        "paged_decode_attention_simt")
    _assert_b8_close(simt, want, torch.bfloat16)


@pytest.mark.parametrize("n_split", (1, 4))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_paged_decode_attention_poisoned_shared_and_empty(cuda_device,
                                                          dtype, n_split):
    """NaN in every page outside the plan and in the dead slots of live
    pages; two sequences sharing pages, one page repeated; one sequence
    of length 0 (zeros)."""
    b, h, kvh, dh, ps, pmax = 4, 32, 2, 128, 16, 12
    q, kp, vp, table, lens = _attn_case(b, h, kvh, dh, ps, pmax, dtype,
                                        seed=11, lens=[37, 0, 190, 64])
    table[3, :4] = torch.tensor([table[0, 2], table[0, 0], table[0, 2],
                                 table[2, 5]])
    want = paref.paged_decode_attention(q, kp, vp, table, lens)
    # Slots of each page live for some sequence: a prefix of the page.
    live = {}
    for i in range(b):
        n = int(lens[i])
        for j in range(-(-n // ps)):
            pg = int(table[i, j])
            live[pg] = max(live.get(pg, 0), min(ps, n - j * ps))
    for pg in range(kp.shape[0]):
        kp[pg, :, live.get(pg, 0):] = float("nan")
        vp[pg, :, live.get(pg, 0):] = float("nan")
    name = _b8_kernel(dtype, h, kvh, dh)
    got = _b8_launched(lambda: pak.paged_decode_attention(
        *_on(cuda_device, q, kp, vp, table, lens), n_split=n_split),
        name).cpu()
    assert bool(torch.isfinite(got).all())
    assert not bool(got[1].any())
    _assert_b8_close(got, want, dtype)
    # A NaN in a live slot is not hidden.
    kp[table[0, 0], 0, 0] = float("nan")
    got = _b8_launched(lambda: pak.paged_decode_attention(
        *_on(cuda_device, q, kp, vp, table, lens), n_split=n_split),
        name).cpu()
    assert bool(got[0, :h // kvh].isnan().all())
    assert bool(torch.isfinite(got[2]).all()) and not bool(got[1].any())


def test_paged_decode_attention_refuses_what_it_does_not_take(cuda_device):
    q, kp, vp, table, lens = _on(cuda_device, *_attn_case(
        2, 8, 2, 16, 4, 6, torch.float32, seed=1))
    with pytest.raises(TypeError):                       # float64
        pak.paged_decode_attention(q.double(), kp.double(), vp.double(),
                                   table, lens)
    with pytest.raises(TypeError):                       # mixed dtypes
        pak.paged_decode_attention(q, kp.bfloat16(), vp.bfloat16(), table,
                                   lens)
    with pytest.raises(ValueError, match="contiguous"):
        pak.paged_decode_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pak.paged_decode_attention(q, kp.transpose(2, 3).contiguous()
                                   .transpose(2, 3), vp, table, lens)
    with pytest.raises(TypeError):                       # int64 table
        pak.paged_decode_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError):                      # CPU lengths
        pak.paged_decode_attention(q, kp, vp, table, lens.cpu())
    with pytest.raises(ValueError, match="group"):       # 8 heads, 3 KV
        pak.paged_decode_attention(q, kp[:, :1].expand(-1, 3, -1, -1)
                                   .contiguous(), vp[:, :1].expand(
                                       -1, 3, -1, -1).contiguous(),
                                   table, lens)
    with pytest.raises(IndexError, match="block_table"):  # page past NP
        paops.paged_decode_attention(q, kp, vp, table + kp.shape[0], lens)
    with pytest.raises(IndexError, match="seq_lens"):     # past PMAX·PS
        paops.paged_decode_attention(q, kp, vp, table, lens + 25)
    with pytest.raises(RuntimeError, match="CUDA error"):  # G·Dh too big
        big = torch.zeros((1, 256, 256), device=cuda_device)
        pak.paged_decode_attention(big, kp[:, :1, :, :1].expand(
            -1, -1, -1, 256).contiguous(), vp[:, :1, :, :1].expand(
            -1, -1, -1, 256).contiguous(), table[:1], lens[:1])


@pytest.mark.parametrize("arch", ("glm4-9b", "yi-34b", "arctic-480b"))
def test_engine_on_the_card_equals_plain_attention(cuda_device, arch,
                                                   monkeypatch):
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = configs.get_config(arch, smoke=True)
    params = tf.init_params(cfg, device=cuda_device, seed=2)
    gen = np.random.default_rng(5)
    prompts = [gen.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (3, 17, 9, 30, 6)]

    def serve():
        eng = ServeEngine(params, cfg, EngineConfig(
            max_batch=3, max_seq=64, page_size=8, n_pages=40),
            device=cuda_device)
        for rid, p in enumerate(prompts):
            eng.submit(Request(prompt=p, rid=rid, max_new_tokens=10))
        done = eng.run()
        return [(r.rid, r.out_tokens) for r in done], eng

    # The smoke configurations are float32: the CUDA-core kernel.
    name = _b8_kernel(cfg.dtype, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    assert name == "paged_decode_attention_simt"
    before = dict(LAUNCHES)
    got, eng = serve()
    launched = LAUNCHES[name] - before[name]
    assert launched > 0 and launched % cfg.n_layers == 0
    assert LAUNCHES["paged_decode_attention"] == \
        before["paged_decode_attention"]
    assert eng.k_pool.is_cuda and eng.pager.utilization == 0.0
    monkeypatch.setattr(pak, "paged_decode_attention",
                        lambda *a, **kw: paref.paged_decode_attention(*a))
    want, _ = serve()
    assert LAUNCHES[name] - before[name] == launched
    assert got == want


def test_paged_decode_attention_refuses_minus_one_among_live_pages(
        cuda_device):
    """A -1 among a sequence's first ceil(seq_lens / PS) entries raises
    before a launch; -1 past them is padding and launches B8."""
    q, kp, vp, table, lens = _on(cuda_device, *_attn_case(
        3, 8, 2, 16, 4, 6, torch.float32, seed=4, lens=[9, 24, 1]))
    name = "paged_decode_attention_simt"                 # float32
    before = LAUNCHES[name]
    _b8_launched(lambda: paops.paged_decode_attention(q, kp, vp, table,
                                                      lens), name)
    for i, last in enumerate((2, 5, 0)):
        bad = table.clone()
        bad[i, last] = -1
        with pytest.raises(IndexError, match="live pages"):
            paops.paged_decode_attention(q, kp, vp, bad, lens)
    assert LAUNCHES[name] == before + 1


# -- MoE routing, the MoE layer and MLA (plain PyTorch on the card) ------------

def _moe_params(cfg, seed):
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(seed)
    return moe.moe_init(cfg, generator=gen, device=torch.device("cpu"),
                        dtype=torch.float32)


@pytest.mark.parametrize("e,k,t", [(256, 8, 1024), (128, 2, 1000),
                                   (8, 2, 7)])
@pytest.mark.parametrize("ties", (False, True))
def test_route_on_the_card_equals_the_cpu(cuda_device, e, k, t, ties):
    """The same float32 logits route to the same bytes on both devices:
    ids, gates, positions, kept slots (and the float32 probabilities)."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=4, d_ff=4, n_experts=e, top_k=k)
    gen = torch.Generator().manual_seed(e + t)
    logits = torch.randn(2, t, e, generator=gen) * 2
    if ties:
        logits = torch.round(logits)          # many equal values a row
    for dropless in (False, True):
        got = moe.route(logits.to(cuda_device), cfg, dropless)
        want = moe.route(logits, cfg, dropless)
        assert got.capacity == want.capacity
        for a, b in zip(got[:5], want[:5]):
            assert _bytes_equal(a.cpu(), b)
        assert dropless or not bool(want.keep.all())


@pytest.mark.parametrize("n_shared,n_groups,shape",
                         [(1, 32, (1, 64)), (1, 32, (1, 50)),
                          (0, 32, (8, 1)), (0, 1, (2, 9))])
@pytest.mark.parametrize("dropless", (False, True))
def test_moe_ffn_on_the_card(cuda_device, n_shared, n_groups, shape,
                             dropless):
    """``moe_ffn`` in float32 (TF32 off) on the card against the CPU:
    the same routing, values within rtol = atol = 2e-5 (cuBLAS and the
    CPU order their float32 products their own way)."""
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = moe.MoEConfig(d_model=32, d_ff=48, n_experts=16, top_k=4,
                        n_shared=n_shared, n_groups=n_groups)
    params = _moe_params(cfg, seed=1)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(*shape, 32, generator=gen)
    want, aux = moe.moe_ffn(params, cfg, x, dropless=dropless)
    on = {key: v.to(cuda_device) if torch.is_tensor(v) else
          {kk: vv.to(cuda_device) for kk, vv in v.items()}
          for key, v in params.items()}
    got, got_aux = moe.moe_ffn(on, cfg, x.to(cuda_device),
                               dropless=dropless)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_aux.cpu(), aux, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_lora_rank", (None, 24))
def test_mla_on_the_card(cuda_device, q_lora_rank):
    """``mla_forward`` and the paged MLA decode in float32 on the card
    against the CPU, within rtol = atol = 2e-5."""
    from repro_torch.models import attention as attn

    cfg = attn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, d_head=16,
                          q_lora_rank=q_lora_rank, kv_lora_rank=16,
                          qk_nope_dim=8, qk_rope_dim=8, v_head_dim=12)
    gen = torch.Generator().manual_seed(3)
    params = attn.mla_init(cfg, generator=gen, device=torch.device("cpu"),
                           dtype=torch.float32)
    on = {key: v.to(cuda_device) if torch.is_tensor(v) else
          {kk: vv.to(cuda_device) for kk, vv in v.items()}
          for key, v in params.items()}
    x = torch.randn(2, 11, 32, generator=gen)
    pos = torch.arange(11)[None].expand(2, 11)
    want, kv = attn.mla_forward(params, cfg, x, pos, q_chunk=4,
                                return_cache=True)
    got, gkv = attn.mla_forward(on, cfg, x.to(cuda_device),
                                pos.to(cuda_device), q_chunk=4,
                                return_cache=True)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    # the paged decode: both sequences' 11 rows in pages of 4, one step
    c_pool = torch.zeros(8, 4, 16)
    r_pool = torch.zeros(8, 4, 8)
    table = torch.tensor([[5, 0, 2, -1], [1, 7, 3, 6]], dtype=torch.int32)
    t = torch.arange(11)
    for b in range(2):
        c_pool[table[b, t // 4].long(), t % 4] = kv["c_kv"][b]
        r_pool[table[b, t // 4].long(), t % 4] = kv["k_rope"][b]
    lens = torch.tensor([12, 12], dtype=torch.int32)
    xd = torch.randn(2, 1, 32, generator=gen)
    args = (xd, c_pool, r_pool, lens - 1, table, lens)
    want = attn.mla_decode_paged(params, cfg, *[a.clone() for a in args])
    got = attn.mla_decode_paged(on, cfg, *[a.to(cuda_device) for a in args])
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


# -- two-tower retrieval and BERT4Rec (B1 on the candidate gather) ------------

def test_gather_rows_wide_rows_repeated_ids(cuda_device):
    """B1 at two-tower's row width (D = 256 float32, 1 KB rows), M =
    4,096 with every id repeated, the first and the last row among them."""
    gen = torch.Generator().manual_seed(7)
    table = torch.randn(3000, 256, generator=gen).to(cuda_device)
    idx = torch.randint(0, 3000, (2048,), generator=gen, dtype=torch.int32)
    idx[:2] = torch.tensor([0, 2999])
    idx = torch.cat([idx, idx.flip(0)]).to(cuda_device)
    before = LAUNCHES["gather_rows"]
    got = gops.gather_rows(table, idx)
    assert LAUNCHES["gather_rows"] == before + 1
    assert _bytes_equal(got, gref.gather_rows(table, idx))


def _to_card(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_card(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v, dev) for v in tree]
    return tree.to(dev)


def test_two_tower_on_the_card(cuda_device):
    """A narrow two-tower model (embed 32, towers 64-32) on the card
    against the same weights on the CPU, TF32 off: the scores within
    1e-5 absolute (cuBLAS and the CPU order their float32 products
    their own way; the scores are dot products of unit vectors).  Each
    tower's lookup is one B1 launch, and ids past a table raise before
    any launch (ROADMAP C12)."""
    from repro_torch.models.recsys import TwoTower, TwoTowerConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = TwoTowerConfig(name="narrow", n_users=300, n_items=5000,
                         embed_dim=32, tower=(64, 32))
    host = TwoTower(cfg, device="cpu", seed=3)
    card = TwoTower(cfg, device="cpu", seed=3).to(cuda_device)
    rng = np.random.default_rng(8)
    users = rng.integers(0, cfg.n_users, 4).astype(np.int32)
    items = rng.integers(0, cfg.n_items, 4096).astype(np.int32)
    before = LAUNCHES["gather_rows"]
    with torch.no_grad():
        got = card.score_candidates(users, torch.from_numpy(items).to(
            cuda_device))
        want = host.score_candidates(users, items)
    assert LAUNCHES["gather_rows"] == before + 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    for bad in (-1, cfg.n_items):
        ids = torch.tensor([0, bad], dtype=torch.int32, device=cuda_device)
        with pytest.raises(IndexError):
            card.item(ids)
    assert LAUNCHES["gather_rows"] == before + 2


def _narrow_bert4rec():
    from repro_torch.models.recsys import bert4rec_config

    return dataclasses.replace(bert4rec_config(n_items=3000, seq_len=48),
                               name="bert4rec-narrow", n_layers=3)


def test_bert4rec_on_the_card(cuda_device):
    """A 3-layer BERT4Rec (d 64, 2 heads of 32, 48 positions) on the card
    against the same weights on the CPU, TF32 off: the last position's
    logits within 1e-5 absolute.  Positions and item ids past their
    tables raise before any launch (ROADMAP C12)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import bert4rec_score

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _narrow_bert4rec()
    params = tf.init_params(cfg, device="cpu", seed=4)
    on = _to_card(params, cuda_device)
    items = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (16, cfg.max_seq)))
    with torch.no_grad():
        got = bert4rec_score(on, cfg, items.to(cuda_device))
        want = bert4rec_score(params, cfg, items)
    assert got.shape == (16, cfg.vocab)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    longer = torch.zeros((1, cfg.max_seq + 1), dtype=torch.long,
                         device=cuda_device)
    with pytest.raises(IndexError, match="learned position table"):
        tf.trunk(on, cfg, longer)
    with pytest.raises(IndexError, match="item ids"):
        bert4rec_score(on, cfg, longer[:, :4] + cfg.vocab)


def test_bert4rec_engine_on_the_card_equals_plain_attention(cuda_device,
                                                           monkeypatch):
    """BERT4Rec's engine on the card: each decode round one B8 launch a
    layer on the CUDA-core kernel (float32, G = 1, Dh = 32), the tokens
    equal to a run with B8's plain version in its place; a request past
    the 48 positions is refused (ROADMAP C12)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = _narrow_bert4rec()
    params = tf.init_params(cfg, device=cuda_device, seed=5)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 30, 19, 40)]

    def serve():
        eng = ServeEngine(params, cfg, EngineConfig(
            max_batch=3, max_seq=64, page_size=8, n_pages=32),
            device=cuda_device)
        for rid, p in enumerate(prompts):
            eng.submit(Request(prompt=p, rid=rid, max_new_tokens=8))
        with pytest.raises(ValueError, match="48 learned positions"):
            eng.submit(Request(prompt=prompts[-1], max_new_tokens=9))
        return [(r.rid, r.out_tokens) for r in eng.run()]

    name = _b8_kernel(cfg.dtype, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    assert name == "paged_decode_attention_simt"
    before = dict(LAUNCHES)
    got = serve()
    launched = LAUNCHES[name] - before[name]
    assert launched > 0 and launched % cfg.n_layers == 0
    monkeypatch.setattr(pak, "paged_decode_attention",
                        lambda *a, **kw: paref.paged_decode_attention(*a))
    assert serve() == got
    assert LAUNCHES[name] - before[name] == launched


@pytest.mark.parametrize("n_split", (None, 1, 3))
def test_paged_decode_attention_bert4rec_shape(cuda_device, n_split):
    """B8 in float32 at BERT4Rec's shape: G = 1 (2 heads over 2 KV
    heads), Dh = 32, on the CUDA-core kernel, within 2e-5."""
    case = _attn_case(4, 2, 2, 32, 16, 13, torch.float32, seed=32,
                      lens=[200, 64, 1, 181])
    want = paref.paged_decode_attention(*case)
    got = _b8_launched(lambda: pak.paged_decode_attention(
        *_on(cuda_device, *case), n_split=n_split),
        "paged_decode_attention_simt")
    _assert_b8_close(got, want, torch.float32)


# -- training: B7 differentiated twice, the chunked CE, the LM data plane ---

def test_segment_sum_second_order_on_the_card(cuda_device):
    """The backward of B7's backward (a gather) is B7 again over the same
    plan: one launch, byte-equal to the plain version on the card and on
    the CPU, with no ``index_put_`` or ``index_add_`` in it."""
    msg, ids = _segment_case(30_000, 3000, 32, torch.float32, seed=4)
    ids = ids.to(cuda_device)
    plan = segops.segment_plan(ids, 3000)
    gen = torch.Generator().manual_seed(5)
    m = msg.to(cuda_device).requires_grad_(True)
    grad_out = torch.randn(3000, 32, generator=gen).to(
        cuda_device).requires_grad_(True)
    v = torch.randn(30_000, 32, generator=gen).to(cuda_device)
    (g,) = torch.autograd.grad(segops.segment_sum(m, plan, 3000), m,
                               grad_out, create_graph=True)
    assert _bytes_equal(g.detach(), segref.segment_sum_backward(
        grad_out.detach(), ids))
    before = dict(LAUNCHES)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (gg,) = torch.autograd.grad(g, grad_out, v)
    assert LAUNCHES["segment_sum"] == before["segment_sum"] + 1
    assert LAUNCHES["segment_plan"] == before["segment_plan"]
    names = {e.name for e in prof.events()}
    assert not any("index_put" in n or "index_add" in n for n in names)
    assert _bytes_equal(gg, segref.segment_sum(v, plan, 3000))
    assert _bytes_equal(gg.cpu(), segref.segment_sum(v.cpu(), ids.cpu(),
                                                     3000))


def test_chunked_cross_entropy_on_the_card_equals_cpu(cuda_device):
    """The chunked tied CE's loss, ``dh`` and ``dtable`` at V = 10,000
    (not a multiple of the 4096 chunk) within ``CARD_STEP`` of the same
    call on the CPU (cuBLAS and the CPU sum their float32 products in
    their own orders; TF32 stays off)."""
    from repro_torch.models.layers import cross_entropy_tied_chunked

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(6)
    h = torch.randn(2048, 64, generator=gen)
    table = torch.randn(10_000, 64, generator=gen) * 0.1
    labels = torch.randint(0, 10_000, (2048,), generator=gen)
    weights = (torch.rand(2048, generator=gen) < 0.8).float()
    runs = {}
    for dev in ("cpu", cuda_device):
        hh = h.to(dev).requires_grad_(True)
        tt = table.to(dev).requires_grad_(True)
        loss = cross_entropy_tied_chunked(hh, tt, labels.to(dev),
                                          weights.to(dev), chunk=4096)
        runs[str(dev)] = (loss.detach(), *torch.autograd.grad(loss,
                                                              (hh, tt)))
    for got, want in zip(runs[str(cuda_device)], runs["cpu"]):
        torch.testing.assert_close(got.cpu(), want, **CARD_STEP)


def test_token_cube_batch_on_the_card(cuda_device):
    """One LM batch from a ``TokenCube`` on the card: one
    ``gather_union_slices`` launch and no ``gather_rows``, the tokens
    byte-equal to the CPU cube's (the plain path over numpy)."""
    from repro_torch.dataplane.tokens import TokenCube

    card = TokenCube(vocab=1000, n_docs=8, doc_len=600, device=cuda_device)
    host = TokenCube(vocab=1000, n_docs=8, doc_len=600, device="cpu")
    before = dict(LAUNCHES)
    got = card.batch(3, 8, 256)
    assert LAUNCHES["gather_union_slices"] == \
        before["gather_union_slices"] + 1
    assert LAUNCHES["gather_rows"] == before["gather_rows"]
    want = host.batch(3, 8, 256)
    for k in ("tokens", "labels"):
        assert got[k].is_cuda and got[k].dtype == torch.int32
        assert got[k].cpu().numpy().tobytes() == want[k].tobytes(), k


# -- C14 and the distribution on the card -------------------------------------

def test_gather_plan_runs_one_run_of_2_31_elements(cuda_device):
    """Fault C14: one run (0, 2³¹) of a 2³¹-element uint8 payload (2.1 GB,
    and 2.1 GB of output) is read by one B2 launch, byte for byte."""
    n = 2 ** 31
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    flat = torch.randint(0, 256, (n,), dtype=torch.uint8,
                         device=cuda_device, generator=gen)
    before = LAUNCHES["gather_plan_runs"]
    out = gops.gather_plan_runs(flat, np.array([0]), np.array([n]))
    assert LAUNCHES["gather_plan_runs"] == before + 1
    assert out.shape == (n,) and torch.equal(out, flat)


def _quantized_psum_plain(x, scale_factor=1.0):
    """``quantized_psum``'s arithmetic for a group of one rank, on the
    CPU (``scale_factor`` scales the scale: a planted fault)."""
    x32 = x.detach().float().cpu()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    scale = scale * scale_factor
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q.to(torch.int32).float() * scale


def test_quantized_psum_on_an_nccl_group_of_one(cuda_device, tmp_path):
    """The int8 all-reduce over NCCL, one rank met through a FileStore:
    byte-equal to its arithmetic on the CPU; a halved scale is not."""
    import torch.distributed as dist

    from repro_torch.distributed.compression import quantized_psum

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        x = torch.randn(1 << 20, generator=gen, device=cuda_device)
        got = quantized_psum(x)
        assert got.is_cuda
        assert _bytes_equal(got.cpu(), _quantized_psum_plain(x))
        assert not _bytes_equal(got.cpu(), _quantized_psum_plain(x, 0.5))
    finally:
        dist.destroy_process_group()


# -- B1, B6 and B7 as custom ops on a one-rank NCCL mesh ----------------------
@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A (1, 1) ("data", "model") mesh over an NCCL group of one rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _placed(mesh, t, spec):
    from repro_torch.distributed.sharding import named

    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, *named(mesh, spec))


@pytest.mark.parametrize("table_spec", ("rows", "replicated"))
@pytest.mark.parametrize("op", ("gather_rows", "gather_rows_bag"))
def test_gather_op_on_a_one_rank_mesh(nccl_mesh, op, table_spec):
    """B1 and B6 on DTensors, through ``sharded_rows`` (a table sharded
    on its rows, or replicated with batch-sharded ids): output and the
    table's gradient byte-equal to the plain-tensor call, one launch of
    the kernel each, on the card."""
    from repro_torch.distributed.sharding import P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(5000, 64, generator=gen, device=dev)
    if op == "gather_rows":
        ids = torch.randint(0, 5000, (512,), generator=gen, device=dev,
                            dtype=torch.int32)
        fn, kname, ispec = gops.gather_rows, "gather_rows", P("data")
    else:
        ids = torch.randint(-1, 5000, (512, 4), generator=gen, device=dev,
                            dtype=torch.int32)
        fn, kname, ispec = gops.gather_rows_bag, "gather_rows_bag", \
            P("data", None)
    tspec = P("model", None) if table_spec == "rows" else P()
    with _deterministic():
        before = LAUNCHES[kname]
        t = table.clone().requires_grad_(True)
        want = fn(t, ids)
        want.square().sum().backward()
        assert LAUNCHES[kname] == before + 1
        dt = _placed(nccl_mesh, table.clone(), tspec).requires_grad_(True)
        got = fn(dt, _placed(nccl_mesh, ids, ispec))
        assert LAUNCHES[kname] == before + 2
        got.square().sum().backward()
    assert _bytes_equal(got.full_tensor().detach().cpu(),
                        want.detach().cpu())
    assert _bytes_equal(dt.grad.full_tensor().cpu(), t.grad.cpu())


def test_segment_ops_on_a_one_rank_mesh(nccl_mesh):
    """B7 on DTensors: a plan of edge-sharded ids (one ``segment_plan``),
    ``segment_gather`` of node-sharded rows and ``segment_sum`` back, the
    rows' gradient through B7 again: byte-equal to the plain-tensor
    calls, with the same launches."""
    from repro_torch.distributed.sharding import P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n, e, d = 3000, 20000, 40
    ids = torch.randint(-1, n, (e,), generator=gen, device=dev,
                        dtype=torch.int32)
    values = torch.randn(n, d, generator=gen, device=dev)
    axes = ("data", "model")

    def run(v, i):
        plan = segops.segment_plan(i, n)
        rows = segops.segment_gather(v, plan, n)
        out = segops.segment_sum(rows * rows, plan, n)
        out.sum().backward()
        return out

    with _deterministic():
        before = dict(LAUNCHES)
        v0 = values.clone().requires_grad_(True)
        want = run(v0, ids)
        plain = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        assert plain["segment_sum"] == 2 and plain["segment_plan"] == 1
        before = dict(LAUNCHES)
        v1 = _placed(nccl_mesh, values.clone(),
                     P(axes, None)).requires_grad_(True)
        got = run(v1, _placed(nccl_mesh, ids, P(axes)))
        assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == plain
    assert _bytes_equal(got.full_tensor().detach().cpu(),
                        want.detach().cpu())
    assert _bytes_equal(v1.grad.full_tensor().cpu(), v0.grad.cpu())


@pytest.mark.parametrize("arch_id,shape", spmd_cases.ONE_RANK_CELLS,
                         ids=[f"{a}-{s}" for a, s in
                              spmd_cases.ONE_RANK_CELLS])
def test_cell_on_a_one_rank_nccl_mesh(nccl_mesh, arch_id, shape):
    """Each of the 16 cells' ``Lowering.fn`` (smoke configurations, the
    cases of ``tests/torch_spmd_cases.py``) on DTensors over the (1, 1)
    NCCL mesh, against the same ``fn`` on plain tensors on the card:
    every result bit for bit (deterministic mode) and the same kernel
    launches, B1, B6 or B7 among them."""
    low, model, args = spmd_cases.smoke_cell(arch_id, shape, nccl_mesh,
                                             device="cuda")
    launches = {}
    with _deterministic():
        plain, on_mesh = spmd_cases._run_cell(low, model, args, nccl_mesh,
                                              launches=launches)
    assert launches["plain"] == launches["mesh"]
    kname = {"nequip": "segment_sum", "two-tower-retrieval": "gather_rows"
             }.get(arch_id, "gather_rows_bag")
    assert sum(v for k, v in launches["mesh"].items()
               if k.startswith(kname)) > 0, launches
    bad = [k for k in plain if plain[k].tobytes() != on_mesh[k].tobytes()]
    assert not bad, bad
