"""The port's extraction read == the JAX package's, byte for byte.

B2 (``gather_plan_runs``) copies a plan's coalesced runs straight into
its points, and ``gather_union_slices`` reads a serving window's union
and every plan's slice of it at once.  On the CPU both run their plain
versions, held here against the JAX package: its ``gather_plan_runs``
(the chunk lattice and its compaction, with the Pallas kernel in
interpret mode and with the jnp path) and its service, whose union read
and slices are ``gather_rows`` of ``gather_rows``.  A numpy emulation of
the CUDA kernel's work order (a warp per output window, its first run by
a warp-wide search, 32 runs a step, elements numbered by a scan over the
lanes and found by a 5-step shuffle search, long overlaps copied whole
in 16- or 8-byte words) is held against the plain version, so that the
order itself is shown to give the reference's bytes; the kernels run on
the card in ``test_torch_cuda.py``.  Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import HealthCheck, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.kernels._casting as ref_casting  # noqa: E402
from repro.core import Polygon, Request, Slicer, Span  # noqa: E402
from repro.dataplane import weather as ref_weather  # noqa: E402
from repro.kernels.gather import ops as ref_gather_ops  # noqa: E402
from repro.kernels.gather import ref as ref_gather  # noqa: E402
from repro.serve.extraction import ExtractionService  # noqa: E402

import repro_torch.kernels._casting as port_casting  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gather import kernel as gk  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.kernels.gather import ref as gref  # noqa: E402
from repro_torch.serve import ExtractionService as PortService  # noqa: E402
from repro_torch.serve import shared_union_gather  # noqa: E402
from torch_specs import cube_spec, request_spec  # noqa: E402

WARP = 32
RUN_WINDOW = 256        # output elements a warp copies (csrc/gather.cu)
# Drawn cases: the same examples every run, no example database.
DRAWN = settings(deadline=None, max_examples=40, derandomize=True,
                 database=None, suppress_health_check=[HealthCheck.too_slow])
PLAN_NAMES = ("france", "germany", "italy", "norway", "uk", "seam_box",
              "whole_circle", "all_levels")


@pytest.fixture(scope="module")
def iwc():
    return ref_weather.IrregularWeatherCube()      # 96 × 192, cyclic lon


@pytest.fixture(scope="module")
def port_cube(iwc):
    return carry.datacube_from_spec(cube_spec(iwc.cube))


@pytest.fixture(scope="module")
def plans(iwc):
    reqs = {c: iwc.country_request(c) for c in PLAN_NAMES[:5]}
    reqs["seam_box"] = iwc.seam_box_request(35.0, 62.0, -25.0, 25.0)
    reqs["whole_circle"] = iwc.seam_box_request(40.0, 50.0, -200.0, 200.0)
    reqs["all_levels"] = Request([
        Span("datetime", 0.0, 1e6), Span("level", 0.0, 2.0),
        Polygon(("lat", "lon"), ref_weather.COUNTRIES["germany"])])
    slicer = Slicer(iwc.cube)
    return {name: slicer.extract_plan(r)[0] for name, r in reqs.items()}


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _jax_plan_runs(flat, starts, lengths, use_pallas):
    with jax.enable_x64(flat.dtype == np.float64):
        return np.asarray(ref_gather_ops.gather_plan_runs(
            jnp.asarray(flat), starts, lengths, use_pallas=use_pallas,
            interpret=True))


def _jax_takes(lengths) -> bool:
    """Whether the JAX ``gather_plan_runs`` accepts these runs: its
    ``chunk_runs`` raises where there are runs and every one is empty
    (ROADMAP C6)."""
    return len(lengths) == 0 or lengths.sum() > 0


def _inputs(flat, starts, lengths):
    """``ops.plan_run_inputs`` on a CPU payload: what the kernel is handed."""
    return gops.plan_run_inputs(torch.from_numpy(flat), starts, lengths)


# -- the kernel's work order, emulated ----------------------------------------

def warp_count_le(v, x) -> int:
    """The kernel's warp-wide count of sorted ``v`` at most ``x``: chunks
    of at most 32 tested at their last value, then one value a lane."""
    lane = np.arange(WARP)
    lo, hi = 0, len(v)
    while hi - lo > WARP:
        c = (hi - lo + WARP - 1) // WARP
        e = lo + (lane + 1) * c - 1
        t = (e < hi) & (v[np.minimum(e, hi - 1)] <= x)
        lo += c * int(t.sum())
        hi = min(lo + c, hi)
    i = lo + lane
    return lo + int(((i < hi) & (v[np.minimum(i, hi - 1)] <= x)).sum())


def copy_span_words(src_addr: int, dst_addr: int, n: int, w: int):
    """How the kernel's copy_span moves ``n`` elements of ``w`` bytes:
    (head elements, words of V bytes, V, tail elements)."""
    diff = src_addr ^ dst_addr
    v = 16 if diff % 16 == 0 else 8 if w < 8 and diff % 8 == 0 else w
    head = min(n, (v - dst_addr % v) % v // w)
    words = (n - head) // (v // w)
    return head, words, v, n - head - words * (v // w)


def emulate_gather_plan_runs(flat, starts, lengths, offsets, n_points,
                             long_run, flat_addr=0, out_addr=0):
    """The output of ``gather_plan_runs_kernel`` step by step, with the
    count of writes of each element and the bytes moved as 16-byte
    words; ``flat_addr``/``out_addr`` are the buffers' byte addresses,
    which decide the words of a long overlap."""
    w = flat.dtype.itemsize
    out = np.zeros(n_points, flat.dtype)
    writes = np.zeros(n_points, np.int64)
    wide_bytes = 0
    n_runs = len(starts)
    lane = np.arange(WARP)
    for w0 in range(0, n_points, RUN_WINDOW):
        w1 = min(w0 + RUN_WINDOW, n_points)
        r = warp_count_le(offsets, w0) - 1
        pos = w0
        while pos < w1:
            rr = r + lane
            live = rr < n_runs
            o = np.where(live, offsets[np.minimum(rr, n_runs)], n_points)
            ln = np.where(live, lengths[np.minimum(rr, n_runs - 1)], 0)
            s0 = np.where(live, starts[np.minimum(rr, n_runs - 1)], 0)
            lo = np.maximum(o, pos)
            hi = np.minimum(o + ln, w1)
            ov = np.maximum(hi - lo, 0)
            is_long = ov >= long_run
            mine = np.where(is_long, 0, ov)
            inc = np.cumsum(mine)
            excl = inc - mine
            total = int(inc[-1])
            src_at = s0 + (lo - o) - excl
            dst_at = lo - excl
            for e in range(total):
                k = 0
                for step in (16, 8, 4, 2, 1):
                    if excl[k + step] <= e:
                        k += step
                out[dst_at[k] + e] = flat[src_at[k] + e]
                writes[dst_at[k] + e] += 1
            for k in np.flatnonzero(is_long):
                s, d, n = int(s0[k] + lo[k] - o[k]), int(lo[k]), int(ov[k])
                head, words, v, tail = copy_span_words(
                    flat_addr + s * w, out_addr + d * w, n, w)
                assert head + words * (v // w) + tail == n
                assert (out_addr + (d + head) * w) % v == 0 or words == 0
                out[d:d + n] = flat[s:s + n]
                writes[d:d + n] += 1
                wide_bytes += words * v if v == 16 else 0
            pos = int(hi[-1]) if live[-1] else w1
            r += WARP
    return out, writes, wide_bytes


def _emulate(flat, starts, lengths, long_run=64, flat_addr=0, out_addr=0):
    s, ln, off, n_points = _inputs(flat, starts, lengths)
    return emulate_gather_plan_runs(flat, s.numpy().astype(np.int64),
                                    ln.numpy().astype(np.int64),
                                    off.numpy(), n_points, long_run,
                                    flat_addr, out_addr)


# -- runs drawn to stress the copy ------------------------------------------

@st.composite
def run_sets(draw, max_runs=24):
    """(n, starts, lengths): a payload size and runs that are empty, of
    length 1, longer than 128, adjacent to the one before, ending at the
    payload's last element, or anywhere."""
    n = draw(st.integers(1, 900))
    starts, lengths = [], []
    for _ in range(draw(st.integers(0, max_runs))):
        kind = draw(st.sampled_from(("empty", "one", "long", "adjacent",
                                     "tail", "any")))
        if kind == "empty":
            length = 0
        elif kind == "one":
            length = 1
        elif kind == "long":
            length = draw(st.integers(min(129, n), min(600, n)))
        else:
            length = draw(st.integers(1, min(80, n)))
        if kind == "tail":
            start = n - length
        elif kind == "adjacent" and starts and starts[-1] + lengths[-1] \
                + length <= n:
            start = starts[-1] + lengths[-1]
        else:
            start = draw(st.integers(0, n - length)) if length < n else 0
        starts.append(start)
        lengths.append(length)
    return n, np.asarray(starts, np.int64), np.asarray(lengths, np.int64)


# One of each kind on a 700-element payload: empty, length 1, longer than
# 128, adjacent to the one before, ending at the payload's last element.
EDGE_RUNS = (700, np.array([0, 10, 100, 400, 650]),
             np.array([0, 1, 300, 5, 50]))


# -- B2: gather_plan_runs ----------------------------------------------------

class TestPlanRunsParity:
    @pytest.mark.parametrize("use_pallas", (False, True))
    @pytest.mark.parametrize("name", PLAN_NAMES)
    def test_plans(self, iwc, plans, name, use_pallas):
        plan = plans[name]
        flat = iwc.field_data(seed=11).astype(np.float32)
        want = _jax_plan_runs(flat, plan.run_starts, plan.run_lengths,
                              use_pallas)
        got = gops.gather_plan_runs(torch.from_numpy(flat), plan.run_starts,
                                    plan.run_lengths)
        plain = gref.gather_plan_runs(torch.from_numpy(flat),
                                      *_inputs(flat, plan.run_starts,
                                               plan.run_lengths))
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        np.testing.assert_array_equal(_bytes(plain), _bytes(want))
        np.testing.assert_array_equal(_bytes(got), _bytes(flat[plan.offsets]))

    @pytest.mark.parametrize("dtype", (np.float64, np.int16, np.uint8))
    def test_plan_dtypes(self, iwc, plans, dtype):
        plan = plans["all_levels"]
        flat = (iwc.field_data(seed=12) * 10).astype(dtype)
        got = gops.gather_plan_runs(torch.from_numpy(flat), plan.run_starts,
                                    plan.run_lengths)
        want = _jax_plan_runs(flat, plan.run_starts, plan.run_lengths, False)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))

    @DRAWN
    @given(case=run_sets())
    @example(case=EDGE_RUNS)
    def test_drawn_runs(self, case):
        n, starts, lengths = case
        flat = np.random.default_rng(n).normal(size=n)
        got = gops.gather_plan_runs(torch.from_numpy(flat), starts, lengths)
        expect = np.concatenate([flat[s:s + ln] for s, ln in
                                 zip(starts, lengths)] + [flat[:0]])
        np.testing.assert_array_equal(_bytes(got), _bytes(expect))
        if _jax_takes(lengths):
            want = _jax_plan_runs(flat, starts, lengths, False)
            np.testing.assert_array_equal(_bytes(got), _bytes(want))

    @settings(DRAWN, max_examples=8)
    @given(case=run_sets(max_runs=8))
    @example(case=EDGE_RUNS)
    def test_drawn_runs_pallas(self, case):
        n, starts, lengths = case
        flat = np.random.default_rng(n).normal(size=n).astype(np.float32)
        got = gops.gather_plan_runs(torch.from_numpy(flat), starts, lengths)
        if _jax_takes(lengths):
            want = _jax_plan_runs(flat, starts, lengths, True)
            np.testing.assert_array_equal(_bytes(got), _bytes(want))
        else:
            assert got.numel() == 0

    def test_only_empty_runs(self):
        """Every run empty: the JAX ``chunk_runs`` indexes the end of an
        empty array and raises; the port reads nothing."""
        flat = np.arange(10, dtype=np.float64)
        starts, lengths = np.array([2, 5]), np.array([0, 0])
        with pytest.raises(IndexError):
            _jax_plan_runs(flat, starts, lengths, False)
        got = gops.gather_plan_runs(torch.from_numpy(flat), starts, lengths)
        assert got.shape == (0,) and got.dtype == torch.float64

    def test_inputs(self):
        flat = np.arange(50, dtype=np.float64)
        starts = np.array([3, 7, 49, 2 ** 40, 10])      # 2**40: empty run
        lengths = np.array([4, 1, 1, 0, 0])
        s, ln, off, n_points = _inputs(flat, starts, lengths)
        assert (s.dtype, ln.dtype, off.dtype) == (torch.int32, torch.int32,
                                                  torch.int64)
        np.testing.assert_array_equal(s.numpy(), [3, 7, 49, 0, 0])
        np.testing.assert_array_equal(ln.numpy(), lengths)
        np.testing.assert_array_equal(off.numpy(), [0, 4, 5, 6, 6, 6])
        assert n_points == 6

    def test_bad_runs_raise(self):
        flat = torch.zeros(10)
        with pytest.raises(IndexError):
            gops.gather_plan_runs(flat, np.array([8]), np.array([3]))
        with pytest.raises(IndexError):
            gops.gather_plan_runs(flat, np.array([10]), np.array([1]))
        with pytest.raises(ValueError):
            gops.gather_plan_runs(flat, np.array([1]), np.array([-1]))
        with pytest.raises(ValueError):
            gops.gather_plan_runs(flat, np.array([1, 2]), np.array([1]))

    def test_no_runs(self):
        got = gops.gather_plan_runs(torch.zeros(4, dtype=torch.float64),
                                    np.empty(0, np.int64),
                                    np.empty(0, np.int64))
        assert got.shape == (0,) and got.dtype == torch.float64

    def test_lattice_limit_is_lifted(self, monkeypatch):
        """The JAX function also raises when its chunk lattice (C × 128)
        passes the int32 limit; the port builds no lattice and raises
        only where a run start or the payload does.  Pinned at a limit
        of 2^12 (both packages read ``I32_LIMIT`` at call time)."""
        limit = 2 ** 12
        monkeypatch.setattr(ref_casting, "I32_LIMIT", limit)
        monkeypatch.setattr(port_casting, "I32_LIMIT", limit)
        flat = np.arange(limit - 96, dtype=np.float32)
        starts = np.arange(0, 40 * 96, 96)               # 40 chunks of 128
        lengths = np.full(40, 3)
        with pytest.raises(OverflowError):
            _jax_plan_runs(flat, starts, lengths, False)
        got = gops.gather_plan_runs(torch.from_numpy(flat), starts, lengths)
        want = np.concatenate([flat[s:s + 3] for s in starts])
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        big = torch.zeros(limit + 1)
        with pytest.raises(OverflowError):
            gops.gather_plan_runs(big, np.array([0]), np.array([1]))


class TestPlanRunsOrder:
    @pytest.mark.parametrize("long_run", (1, 32, 64, 10 ** 9))
    @pytest.mark.parametrize("name", PLAN_NAMES)
    def test_emulation_equals_plain(self, iwc, plans, name, long_run):
        plan = plans[name]
        flat = iwc.field_data(seed=13)
        got, writes, _ = _emulate(flat, plan.run_starts, plan.run_lengths,
                                  long_run)
        assert (writes == 1).all()
        np.testing.assert_array_equal(_bytes(got), _bytes(flat[plan.offsets]))

    @settings(DRAWN, max_examples=60)
    @given(case=run_sets(max_runs=64), long_run=st.sampled_from((1, 8, 64)),
           flat_addr=st.sampled_from((0, 2, 8, 12)))
    @example(case=EDGE_RUNS, long_run=64, flat_addr=2)
    def test_emulation_on_drawn_runs(self, case, long_run, flat_addr):
        n, starts, lengths = case
        flat = np.random.default_rng(n + 1).integers(
            0, 255, n).astype(np.uint8)
        got, writes, _ = _emulate(flat, starts, lengths, long_run,
                                  flat_addr=flat_addr)
        assert (writes == 1).all()
        plain = gref.gather_plan_runs(torch.from_numpy(flat),
                                      *_inputs(flat, starts, lengths))
        np.testing.assert_array_equal(_bytes(got), _bytes(plain))

    @pytest.mark.parametrize("flat_addr,wide", [(0, True), (8, False),
                                                (16, True)])
    def test_long_runs_move_as_16_byte_words_when_congruent(self, flat_addr,
                                                            wide):
        """One 1000-element float64 run at an even offset: its interior
        moves as 16-byte words when the payload's and the output's
        addresses are congruent mod 16, and as 8-byte elements when not."""
        flat = np.arange(2000, dtype=np.float64)
        got, writes, wide_bytes = _emulate(flat, np.array([600]),
                                           np.array([1000]),
                                           flat_addr=flat_addr)
        np.testing.assert_array_equal(got, flat[600:1600])
        assert (wide_bytes > 0) == wide

    @pytest.mark.parametrize("n", (1, 31, 32, 33, 1000, 4099))
    def test_warp_count_le(self, n):
        v = np.sort(np.random.default_rng(n).integers(0, 50, n))
        for x in (-1, 0, 7, 25, 49, 60):
            assert warp_count_le(v, x) == int((v <= x).sum())


# -- the serving window: gather_union_slices ---------------------------------

def _window(plans, names):
    nonempty = [plans[k] for k in names if plans[k].n_points]
    union = np.unique(np.concatenate([p.offsets for p in nonempty]))
    return union, [np.searchsorted(union, p.offsets) for p in nonempty]


class TestUnionSlicesParity:
    @pytest.mark.parametrize("names", (("uk", "france"),
                                       ("germany", "all_levels", "germany"),
                                       PLAN_NAMES))
    def test_equals_jax_gather_of_gather(self, iwc, plans, names):
        flat = iwc.field_data(seed=14)
        union, positions = _window(plans, names)
        got = gref.gather_union_slices(
            torch.from_numpy(flat), torch.from_numpy(union),
            torch.from_numpy(np.concatenate(positions)))
        via_ops = gops.gather_union_slices(torch.from_numpy(flat), union,
                                           np.concatenate(positions))
        with jax.enable_x64(True):
            buf = ref_gather.gather_rows(jnp.asarray(flat)[:, None], union)
            want = np.concatenate([np.asarray(ref_gather.gather_rows(
                buf, pos))[:, 0] for pos in positions])
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        np.testing.assert_array_equal(_bytes(via_ops), _bytes(want))

    def test_bad_indices_raise(self):
        flat = torch.zeros(10)
        with pytest.raises(IndexError):
            gops.gather_union_slices(flat, np.array([3, 10]), np.array([0]))
        with pytest.raises(IndexError):
            gops.gather_union_slices(flat, np.array([3, 4]), np.array([2]))
        with pytest.raises(IndexError):
            gops.gather_union_slices(flat, np.array([3, 4]), np.array([-1]))


class TestServiceWindow:
    @pytest.mark.parametrize("seed", range(3))
    def test_shared_union_gather_equals_jax_service(self, iwc, port_cube,
                                                    seed):
        """A window of drawn requests with duplicates and an empty plan:
        values key by key and the byte accounting equal the JAX
        service's, no kernel counted on the CPU."""
        rng = np.random.default_rng(seed)
        pop = [iwc.country_request(c) for c in PLAN_NAMES[:5]]
        pop.append(iwc.seam_box_request(35.0, 62.0, -25.0, 25.0))
        pop.append(iwc.seam_box_request(35.0, 35.0001, 10.0, 10.0001))
        batch = [pop[i] for i in rng.choice(len(pop), 10)] + [pop[-1]]
        data = iwc.field_data(seed=20 + seed)
        ref_svc = ExtractionService(iwc.cube)
        want = ref_svc.submit_batch(batch, data)
        svc = PortService(port_cube, device="cpu")
        results = svc.submit_batch([carry.request_from_spec(request_spec(r))
                                    for r in batch])
        before = dict(LAUNCHES)
        requested, read, _ = shared_union_gather(
            port_cube, results, {r.key: r.plan for r in results},
            torch.from_numpy(data))
        assert LAUNCHES == before
        assert requested == ref_svc.stats.bytes_requested
        assert read == ref_svc.stats.bytes_read
        assert any(r.plan.n_points == 0 for r in results)
        for g, w in zip(results, want):
            assert g.key == w.key
            assert isinstance(g.values, torch.Tensor)
            np.testing.assert_array_equal(_bytes(g.values), _bytes(w.values))
