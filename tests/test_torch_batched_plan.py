"""The batched crop planner: its plain version against the JAX package,
and a numpy emulation of its CUDA kernel against its plain version.

* ``batched_plan_2d`` and ``batched_extract_2d`` with ``device="cpu"``
  (the plain version, ``kernels/slice/ref.py::batched_plan_2d``) against
  ``repro.core.batched`` byte for byte, on the layouts that decide the
  lattice's edges: a polytope with no valid vertex, polytopes wholly off
  the grid, rows past n0, columns past n1, truncation by ``max_rows``
  and by ``max_cols``, vertices on a row's plane, extents that sit
  exactly on an axis value, and extents whose thresholds (``lo - 1e-6``,
  ``hi + 1e-6`` in float32) do.
* ``emulate_batched_plan``: the walk of ``csrc/batched_plan.cu`` in
  numpy, rounding as the kernel rounds (a block per polytope, every warp
  computing the polytope's extents itself with lane partials and xor
  shuffles and its first row by the 32-ary warp search as written; then
  for each chunk of 32 rows lane r cutting row r as
  ``csrc/slice_extents.cuh`` loops and finding its first column by a
  binary search, and the block's warps splitting the chunk's flat
  (row, column) slots, ``SLOT_UNROLL`` a lane a step, each slot taking
  its row's cut from that row's lane; the point count summed over lanes
  and then over the block's warps).  It must equal the plain version
  byte for byte on the same layouts and on seeded random layers (more
  than 32 rows among them), in float32 and float64.
* The field-size check of ``batched_extract_2d`` (ROADMAP C7) raises on
  the CPU path and on the card's path before any device is touched.

All inputs are made with numpy and fed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batched as ref_batched  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch._device import upload  # noqa: E402
from repro_torch.kernels.slice import kernel as port_slice_kernel  # noqa: E402
from repro_torch.kernels.slice import ops as port_slice_ops  # noqa: E402
from repro_torch.kernels.slice import ref as port_slice  # noqa: E402
from torch_batched_cases import (AXIS0, AXIS1, CASES,  # noqa: E402
                                 random_layer)

# csrc/batched_plan.cu's launch: slots a lane takes per step, and warps a
# block takes at most.
SLOT_UNROLL = 4
WARPS = 8


# -- the numpy emulation of csrc/batched_plan.cu -------------------------------

def _xor_reduce(lanes, op):
    """A warp's __shfl_xor_sync tree over 32 lane values."""
    lanes = list(lanes)
    for o in (16, 8, 4, 2, 1):
        lanes = [op(lanes[lane ^ o], lanes[lane]) for lane in range(32)]
    return lanes[0]


def _min(w, v):
    return w if w < v else v


def _max(w, v):
    return w if w > v else v


def warp_lower_bound(a, n, x):
    """The kernel's 32-ary search; returns (index, rounds)."""
    lo, hi, rounds = 0, n, 0
    while lo < hi:
        s = (hi - lo + 31) // 32
        probes = [lo + (lane + 1) * s - 1 for lane in range(32)]
        k = sum(1 for q in probes if q < hi and a[q] < x)      # popc(ballot)
        next_hi = lo + (k + 1) * s - 1
        lo += k * s
        hi = min(next_hi, hi)
        rounds += 1
    return lo, rounds


def _cut(x, y, m, plane, tol):
    """slice_minor_extents of csrc/slice_extents.cuh, one rounding an
    operation in x's dtype."""
    f = x.dtype.type
    lo, hi = f(np.inf), f(-np.inf)
    any_on = any_below = any_above = False
    for i in range(x.size):
        if not m[i]:
            continue
        d = x[i] - plane
        if abs(d) <= tol:
            lo, hi = _min(y[i], lo), _max(y[i], hi)
            any_on = True
        any_below |= bool(d < -tol)
        any_above |= bool(d > tol and np.isfinite(d))
    if any_below and any_above:
        for i in range(x.size):
            di = x[i] - plane
            if not m[i] or not di < -tol:
                continue
            for j in range(x.size):
                dj = x[j] - plane
                if not m[j] or not (dj > tol and np.isfinite(dj)):
                    continue
                denom = di - dj
                t = di / (f(1) if denom == 0 else denom)
                yp = y[i] + t * (y[j] - y[i])
                lo, hi = _min(yp, lo), _max(yp, hi)
    return lo, hi, any_on or (any_below and any_above)


def lower_bound(a, n, x):
    """The kernel's one-lane binary search."""
    lo, hi = 0, n
    while lo < hi:
        mid = lo + (hi - lo) // 2
        if a[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _launch_warps(rows, cols):
    """The warps of a block: at most WARPS, at most the steps of slots in
    a chunk of 32 rows, at least one."""
    chunk = min(rows, 32) * cols
    steps = -(-chunk // (32 * SLOT_UNROLL))
    return max(1, min(WARPS, steps))


def emulate_batched_plan(verts, valid, axis0, axis1, n0, n1, rows, cols,
                         field=None):
    """csrc/batched_plan.cu's walk: (offsets, n_points, values)."""
    f = verts.dtype.type
    p_count, v, _ = verts.shape
    big, eps = f(np.inf), f(1e-6)
    offsets = np.full(p_count * rows * cols, -7, np.int32)
    n_points = np.full(p_count, -7, np.int32)
    values = None if field is None else \
        np.full(p_count * rows * cols, 7, field.dtype)
    warps = _launch_warps(rows, cols)
    step = 32 * SLOT_UNROLL
    with np.errstate(all="ignore"):
        for p in range(p_count):                        # a block
            x, y, m = verts[p, :, 0], verts[p, :, 1], valid[p]
            warp_points = []
            for warp in range(warps):
                lo0_l, hi0_l, amax_l = [big] * 32, [-big] * 32, [f(0)] * 32
                for lane in range(32):
                    for i in range(lane, v, 32):
                        amax_l[lane] = _max(abs(x[i]), amax_l[lane])
                        if m[i]:
                            lo0_l[lane] = _min(x[i], lo0_l[lane])
                            hi0_l[lane] = _max(x[i], hi0_l[lane])
                lo0 = _xor_reduce(lo0_l, _min)
                hi0 = _xor_reduce(hi0_l, _max)
                amax = _xor_reduce(amax_l, _max)
                scale = f(1) if f(1) > amax else amax
                tol = f(1e-6) * scale
                hi0_eps = hi0 + eps
                start, _ = warp_lower_bound(axis0, axis0.size, lo0 - eps)
                lane_points = [0] * 32
                for r0 in range(0, rows, 32):
                    held = []                   # lane r: row r0 + r
                    for lane in range(32):
                        r, hit, c_start, hi1_eps = r0 + lane, 0, 0, f(0)
                        row = start + r
                        if r < rows and row < n0 and axis0[row] <= hi0_eps:
                            lo1, hi1, cut = _cut(x, y, m, axis0[row], tol)
                            if cut:
                                hit = 1
                                c_start = lower_bound(axis1, axis1.size,
                                                      lo1 - eps)
                                hi1_eps = hi1 + eps
                        held.append((hit, c_start, hi1_eps))
                    chunk = min(32, rows - r0) * cols
                    base = (p * rows + r0) * cols
                    for e0 in range(warp * step, chunk, warps * step):
                        for lane in range(32):
                            for u in range(SLOT_UNROLL):
                                e = e0 + 32 * u + lane
                                if e >= chunk:
                                    continue
                                rr, c = divmod(e, cols)
                                hit, c_start, hi1_eps = held[rr]  # shuffle
                                col = c_start + c
                                live = bool(hit) and col < n1 and \
                                    axis1[col] <= hi1_eps
                                off = (start + r0 + rr) * n1 + col \
                                    if live else -1
                                offsets[base + e] = off
                                if values is not None:
                                    values[base + e] = field[off] if live \
                                        else field.dtype.type(0)
                                lane_points[lane] += int(live)
                warp_points.append(_xor_reduce(lane_points,
                                               lambda a, b: a + b))
            n_points[p] = sum(warp_points)
    return (offsets.reshape(p_count, rows, cols), n_points,
            None if values is None else values.reshape(p_count, -1))


# -- helpers -------------------------------------------------------------------

def _plain(verts, valid, rows, cols, field=None, axis0=AXIS0, axis1=AXIS1):
    tens = [torch.from_numpy(a) for a in (verts, valid, axis0, axis1)]
    return port_slice.batched_plan_2d(
        *tens, axis0.size, axis1.size, rows, cols,
        None if field is None else torch.from_numpy(field))


def _assert_bytes_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _field(dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = AXIS0.size * AXIS1.size
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=n).astype(dtype)
    if np.dtype(dtype).kind == "b":
        return rng.integers(0, 2, n).astype(dtype)
    return rng.integers(1, 100, n).astype(dtype)


# -- the plain version against the JAX package ---------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_plan_matches_jax(case):
    (verts, valid), rows, cols = CASES[case]
    got = port_core.batched_plan_2d(verts, valid, AXIS0, AXIS1, AXIS0.size,
                                    AXIS1.size, rows, cols, device="cpu")
    want = ref_batched.batched_plan_2d(
        jnp.asarray(verts), jnp.asarray(valid), jnp.asarray(AXIS0),
        jnp.asarray(AXIS1), AXIS0.size, AXIS1.size, max_rows=rows,
        max_cols=cols)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


@pytest.mark.parametrize("dtype", (np.float32, np.int16, np.uint8,
                                   np.bool_))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_extract_matches_jax(case, dtype):
    """Values, offsets and counts byte-equal, dtype included: a bool
    field's values come back as int32 (ROADMAP C10)."""
    (verts, valid), rows, cols = CASES[case]
    field = _field(dtype)
    got = port_core.batched_extract_2d(torch.from_numpy(field), verts, valid,
                                       AXIS0, AXIS1, rows, cols,
                                       device="cpu")
    want = ref_batched.batched_extract_2d(
        jnp.asarray(field), jnp.asarray(verts), jnp.asarray(valid),
        jnp.asarray(AXIS0), jnp.asarray(AXIS1), max_rows=rows,
        max_cols=cols)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


def test_cases_reach_their_edges():
    """Each layout shows the edge it is named for."""
    def plan(case):
        (verts, valid), rows, cols = CASES[case]
        off, npts, _ = _plain(verts, valid, rows, cols)
        return off.numpy(), npts.numpy()

    assert plan("all_invalid")[1][0] == 0 < plan("all_invalid")[1][1]
    assert (plan("off_grid")[1] == 0).all()
    off, _ = plan("rows_past_n0")
    live_rows = (off >= 0).any(2)[0]
    assert live_rows.any() and not live_rows[-1]
    assert off.max() // AXIS1.size == AXIS0.size - 1
    off, _ = plan("cols_past_n1")
    assert (off[off >= 0] % AXIS1.size).max() == AXIS1.size - 1
    assert (off >= 0).any(2).sum() > 0 and (off < 0).any()
    assert (plan("truncated_rows")[0] >= 0).any(2).all()
    assert (plan("truncated_cols")[0] >= 0).all(2).any()
    off, _ = plan("lo_on_axis")
    live = off[0][off[0] >= 0]
    assert AXIS0[live // AXIS1.size].min() == -2.5
    assert AXIS0[live // AXIS1.size].max() == 4.0
    assert AXIS1[live % AXIS1.size].min() == 2.0
    assert AXIS1[live % AXIS1.size].max() == 5.5
    off, _ = plan("eps_on_axis")
    live = off[0][off[0] >= 0]
    assert (AXIS0[live // AXIS1.size].min(), AXIS0[live // AXIS1.size].max(),
            AXIS1[live % AXIS1.size].min(),
            AXIS1[live % AXIS1.size].max()) == (-2.5, 5.5, 2.0, 6.0)


# -- the kernel's walk against the plain version -------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_walk_matches_plain_on_the_edges(case):
    (verts, valid), rows, cols = CASES[case]
    field = _field(np.float32, seed=1)
    want = _plain(verts, valid, rows, cols, field)
    got = emulate_batched_plan(verts, valid, AXIS0, AXIS1, AXIS0.size,
                               AXIS1.size, rows, cols, field)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


@pytest.mark.parametrize("rows,cols", [(10, 20), (3, 40), (17, 9),
                                       (40, 12)])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_walk_matches_plain_on_random_layers(seed, rows, cols):
    verts, valid = random_layer(seed)
    field = _field(np.int16, seed=seed)
    want = _plain(verts, valid, rows, cols, field)
    got = emulate_batched_plan(verts, valid, AXIS0, AXIS1, AXIS0.size,
                               AXIS1.size, rows, cols, field)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)
    assert int(want[1].sum()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_kernel_walk_matches_plain_in_float64(seed):
    verts, valid = random_layer(seed, dtype=np.float64)
    axis0, axis1 = AXIS0.astype(np.float64), AXIS1.astype(np.float64)
    want = _plain(verts, valid, 12, 16, axis0=axis0, axis1=axis1)
    got = emulate_batched_plan(verts, valid, axis0, axis1, axis0.size,
                               axis1.size, 12, 16)
    for g, w in zip(got[:2], want[:2]):
        _assert_bytes_equal(g, w)
    assert got[2] is None and want[2] is None


def test_searches_are_searchsorted_left():
    """The 32-ary warp search and the one-lane binary search on sorted axes with ties, at keys below, above,
    between and on their values, in 2 rounds at n = 640 and 3 at 1280
    (the F320 axes)."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 32, 33, 640, 1000, 1280):
        a = np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.float32)
        keys = np.concatenate([a, a + 0.5, a - 0.5,
                               [-np.inf, np.inf, -1e9, 1e9]]).astype(
            np.float32)
        for x in keys:
            got, rounds = warp_lower_bound(a, n, x)
            assert got == np.searchsorted(a, x, side="left"), (n, x)
            assert lower_bound(a, n, x) == got, (n, x)
    assert warp_lower_bound(AXIS0, 0, np.float32(0))[1] == 0
    for n, most in ((640, 2), (1280, 3)):
        a = np.arange(n, dtype=np.float32)
        assert max(warp_lower_bound(a, n, np.float32(x) - 0.25)[1]
                   for x in range(0, n + 1, 7)) == most


# -- the field-size check (ROADMAP C7) ------------------------------------------

def _short_field_call(device):
    (verts, valid), rows, cols = CASES["lo_on_axis"]
    field = np.zeros(AXIS0.size * AXIS1.size - 1, np.float32)
    return lambda: port_core.batched_extract_2d(
        field, verts, valid, AXIS0, AXIS1, rows, cols, device=device)


def test_short_field_raises_on_the_cpu():
    with pytest.raises(IndexError, match="field of 383 elements"):
        _short_field_call("cpu")()


def test_short_field_raises_before_the_card_is_touched(monkeypatch):
    """The card's path checks on the host before any device work: with no
    card at all the field's size is what raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(IndexError, match="grid of 16 x 24"):
        _short_field_call(None)()


def test_jax_reads_a_short_field_whose_offsets_fit():
    """The difference C7 records: the JAX function only reads where the
    offsets point, so a short field whose plan stays inside it passes."""
    (verts, valid), rows, cols = CASES["lo_on_axis"]
    field = _field(np.float32)[:-1]
    vals, off, _ = ref_batched.batched_extract_2d(
        jnp.asarray(field), jnp.asarray(verts), jnp.asarray(valid),
        jnp.asarray(AXIS0), jnp.asarray(AXIS1), max_rows=rows,
        max_cols=cols)
    off = np.asarray(off).reshape(off.shape[0], -1)
    assert off.max() < field.size
    np.testing.assert_array_equal(
        np.asarray(vals), np.where(off >= 0, field[np.maximum(off, 0)], 0))


# -- host side: the upload, the dispatch, the wrapper's checks ------------------

def test_upload_keeps_dtypes_and_shapes():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([[True, False, True]]),
              np.linspace(0, 1, 5), np.arange(3, dtype=np.int32),
              np.zeros((0, 2), np.float32)]
    for a, t in zip(arrays, upload(torch.device("cpu"), *arrays)):
        assert t.dtype == torch.from_numpy(a).dtype
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)


def test_entry_points_hand_numpy_and_tensors_alike():
    (verts, valid), rows, cols = CASES["on_plane"]
    from_numpy = port_core.batched_plan_2d(
        verts, valid, AXIS0, AXIS1, AXIS0.size, AXIS1.size, rows, cols,
        device="cpu")
    from_tensors = port_core.batched_plan_2d(
        *(torch.from_numpy(a) for a in (verts, valid, AXIS0, AXIS1)),
        AXIS0.size, AXIS1.size, rows, cols, device="cpu")
    for a, b in zip(from_numpy, from_tensors):
        assert torch.equal(a, b)


def test_ops_dispatch_on_the_tensors_device():
    (verts, valid), rows, cols = CASES["on_plane"]
    tens = [torch.from_numpy(a) for a in (verts, valid, AXIS0, AXIS1)]
    got = port_slice_ops.batched_plan_2d(*tens, 16, 24, rows, cols)
    want = port_slice.batched_plan_2d(*tens, 16, 24, rows, cols)
    assert got[2] is None
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no slicing path"):
        port_slice_ops.batched_plan_2d(*(t.to("meta") for t in tens), 16,
                                       24, rows, cols)


def test_kernel_wrapper_takes_only_cuda_tensors():
    (verts, valid), rows, cols = CASES["on_plane"]
    tens = [torch.from_numpy(a) for a in (verts, valid, AXIS0, AXIS1)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_slice_kernel.batched_plan_2d(*tens, 16, 24, rows, cols)
