"""The port's batched slicing and batched planning == the JAX package's.

* ``slice_batch`` (kernel B5's plain version) against
  ``repro.kernels.slice.ref.slice_batch`` and the Pallas kernel in
  interpret mode.  Masks must be equal.  Coordinates agree within
  rtol = atol = 1e-5, the JAX package's own tolerance for this kernel
  (tests/test_kernels.py): XLA's CPU compiler contracts the float32 lerp
  ``v_i + t * (v_j - v_i)`` into a fused multiply-add, where the port
  rounds every operation on its own as the CUDA kernel does (built with
  ``--fmad=false``).  Against a numpy float32 version that rounds each
  operation, the port is exact.
* ``pack_polytopes`` and ``unpack_sliced`` parity, and agreement with
  the host ``slice_vertices``.
* ``batched_plan_2d``, ``batched_plan_runs_2d`` and
  ``batched_extract_2d`` with ``device="cpu"`` against
  ``repro.core.batched``: offset lattices, runs, ``meta`` and values are
  exact.

All inputs are made from a seed with numpy and fed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batched as ref_batched  # noqa: E402
from repro.core.geometry import Polytope  # noqa: E402
from repro.core.geometry import slice_vertices  # noqa: E402
from repro.core.hull import convex_hull_prune  # noqa: E402
from repro.dataplane import weather as ref_weather  # noqa: E402
from repro.kernels.slice import kernel as ref_slice_kernel  # noqa: E402
from repro.kernels.slice import ops as ref_slice_ops  # noqa: E402
from repro.kernels.slice import ref as ref_slice  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.core.geometry import Polytope as PortPolytope  # noqa: E402
from repro_torch.kernels.slice import ops as port_slice_ops  # noqa: E402
from repro_torch.kernels.slice import ref as port_slice  # noqa: E402

SLICE_SHAPES = [(4, 6, 3, 0), (10, 8, 4, 2), (1, 4, 2, 1), (9, 12, 5, 4)]


def _slice_inputs(p, v, d, k):
    """The inputs of tests/test_kernels.py::TestSliceBatch."""
    rng = np.random.default_rng(p * v + d + k)
    verts = rng.uniform(0, 10, (p, v, d)).astype(np.float32)
    nvalid = rng.integers(2, v + 1, p)
    valid = np.arange(v)[None, :] < nvalid[:, None]
    planes = rng.uniform(0, 10, p).astype(np.float32)
    return verts, valid, planes


def _numpy_slice_batch(verts, valid, planes, k):
    """float32 numpy, one rounding per operation: the port's contract."""
    f32 = np.float32
    p, v, d = verts.shape
    c = planes[:, None]
    coord = verts[:, :, k]
    scale = np.maximum(f32(1), np.abs(coord).max(1, keepdims=True))
    dist = np.where(valid, coord - c, f32(np.inf)).astype(f32)
    tol = f32(1e-6) * scale
    on = (np.abs(dist) <= tol) & valid
    below = (dist < -tol) & valid
    above = (dist > tol) & np.isfinite(dist) & valid
    on_pts = verts.copy()
    on_pts[:, :, k] = c
    di = np.where(below, dist, f32(0))[:, :, None]
    dj = np.where(above, dist, f32(0))[:, None, :]
    denom = di - dj
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(np.abs(denom) > 0,
                     di / np.where(denom == 0, f32(1), denom), f32(0))
    vi, vj = verts[:, :, None, :], verts[:, None, :, :]
    interp = (vi + t[..., None].astype(f32) * (vj - vi)).astype(f32)
    interp[:, :, :, k] = c[:, :, None]
    pair = below[:, :, None] & above[:, None, :]
    out = np.concatenate([on_pts, interp.reshape(p, v * v, d)], axis=1)
    mask = np.concatenate([on, pair.reshape(p, v * v)], axis=1)
    return np.where(mask[..., None], out, f32(0)), mask


def _port_tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- B5: slice_batch ----------------------------------------------------------

class TestSliceBatch:
    @pytest.mark.parametrize("p,v,d,k", SLICE_SHAPES)
    def test_matches_reference_and_pallas_interpret(self, p, v, d, k):
        verts, valid, planes = _slice_inputs(p, v, d, k)
        got_out, got_mask = port_slice.slice_batch(
            *_port_tensors(verts, valid, planes), k)
        args = (jnp.asarray(verts), jnp.asarray(valid), jnp.asarray(planes))
        for out, mask in (ref_slice.slice_batch(*args, k=k),
                          ref_slice_kernel.slice_batch(*args, k=k,
                                                       interpret=True)):
            np.testing.assert_array_equal(got_mask.numpy(),
                                          np.asarray(mask))
            # rtol = atol = 1e-5: the JAX package's tolerance for B5
            np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                                       rtol=1e-5, atol=1e-5)
        assert got_out.dtype == torch.float32 and got_mask.dtype == torch.bool

    @pytest.mark.parametrize("p,v,d,k", SLICE_SHAPES + [(50, 3, 2, 0)])
    def test_rounds_each_operation(self, p, v, d, k):
        verts, valid, planes = _slice_inputs(p, v, d, k)
        planes[::3] = verts[::3, 0, k]          # on-plane vertices
        got_out, got_mask = port_slice.slice_batch(
            *_port_tensors(verts, valid, planes), k)
        want_out, want_mask = _numpy_slice_batch(verts, valid, planes, k)
        np.testing.assert_array_equal(got_mask.numpy(), want_mask)
        np.testing.assert_array_equal(got_out.numpy().view(np.uint32),
                                      want_out.view(np.uint32))

    def test_masked_slots_are_positive_zero(self):
        verts, valid, planes = _slice_inputs(9, 12, 5, 4)
        out, mask = port_slice.slice_batch(
            *_port_tensors(-verts, valid, -planes), 4)
        dead = out.numpy()[~mask.numpy()]
        assert dead.size and not np.signbit(dead).any()

    def test_ops_dispatches_cpu_tensors_to_the_plain_version(self):
        tens = _port_tensors(*_slice_inputs(10, 8, 4, 2))
        for use_pallas in (False, True):
            got = port_slice_ops.slice_batch(*tens, 2,
                                             use_pallas=use_pallas)
            want = port_slice.slice_batch(*tens, 2)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        with pytest.raises(ValueError, match="no slicing path"):
            port_slice_ops.slice_batch(*(t.to("meta") for t in tens), 2)


# -- B4 on its own: slice_minor_extents ---------------------------------------

@pytest.mark.parametrize("b,v,r", [(64, 5, 20), (3, 3, 7)])
def test_slice_minor_extents_matches_reference(b, v, r):
    rng = np.random.default_rng(b + v + r)
    xy = rng.uniform(-20, 20, (2, b, v)).astype(np.float32)
    valid = np.arange(v)[None, :] < rng.integers(1, v + 1, b)[:, None]
    planes = rng.uniform(-20, 20, (b, r)).astype(np.float32)
    planes[:, 0] = xy[0, :, 0]
    tol = (1e-6 * np.maximum(1.0, np.abs(xy[0]).max(1))).astype(np.float32)
    lo, hi, hit = port_slice_ops.slice_minor_extents(
        *_port_tensors(xy[0], xy[1], valid, planes, tol))
    want = ref_slice.slice_minor_extents(
        jnp.asarray(xy[0][:, None, :]), jnp.asarray(xy[1][:, None, :]),
        jnp.asarray(valid[:, None, :]), jnp.asarray(planes),
        jnp.asarray(tol[:, None]))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want[2]))
    # the same fused-lerp difference as slice_batch: rtol = atol = 1e-5
    for got, ref in zip((lo, hi), want[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    assert lo.shape == (b, r) and hit.dtype == torch.bool


# -- pack and unpack ----------------------------------------------------------

def _layer(seed=7, n=12, d=3):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0, 10, (rng.integers(4, 9), d)) for _ in range(n)]
    axes = ("x", "y", "z")[:d]
    return ([Polytope(axes, p) for p in pts],
            [PortPolytope(axes, p) for p in pts])


class TestPackUnpack:
    @pytest.mark.parametrize("v_max", (None, 8, 5))
    def test_pack_parity(self, v_max):
        ref_polys, port_polys = _layer()
        rv, rm = ref_slice_ops.pack_polytopes(ref_polys, v_max=v_max)
        pv, pm = port_slice_ops.pack_polytopes(port_polys, v_max=v_max,
                                               device="cpu")
        assert pv.dtype == torch.float32 and pm.dtype == torch.bool
        assert pv.device.type == "cpu"
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))

    def test_pack_empty_layer_raises(self):
        with pytest.raises(ValueError, match="empty"):
            port_slice_ops.pack_polytopes([], device="cpu")

    def test_unpack_parity(self):
        ref_polys, port_polys = _layer()
        verts, valid = port_slice_ops.pack_polytopes(port_polys, v_max=8,
                                                     device="cpu")
        planes = torch.from_numpy(np.random.default_rng(7).uniform(
            3, 7, 12).astype(np.float32))
        out, mask = port_slice_ops.slice_batch(verts, valid, planes, 1)
        got = port_slice_ops.unpack_sliced(out, mask, ("x", "y", "z"), 1)
        want = ref_slice_ops.unpack_sliced(out.numpy(), mask.numpy(),
                                           ("x", "y", "z"), 1)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.axes == w.axes == ("x", "z")
                np.testing.assert_array_equal(g.points, w.points)

    def test_agrees_with_host_slicer(self):
        """tests/test_kernels.py::test_agrees_with_host_slicer, on the
        port: every plane the host slices, the layer slices to the same
        vertices (to the float32 rounding the JAX test allows)."""
        rng = np.random.default_rng(7)
        polys = [PortPolytope(("x", "y", "z"), rng.uniform(0, 10, (6, 3)))
                 for _ in range(12)]
        verts, valid = port_slice_ops.pack_polytopes(polys, v_max=8,
                                                     device="cpu")
        planes = rng.uniform(3, 7, 12).astype(np.float32)
        out, mask = port_slice_ops.slice_batch(verts, valid,
                                               torch.from_numpy(planes), 1)
        subs = port_slice_ops.unpack_sliced(out, mask, ("x", "y", "z"), 1)
        hits = 0
        for poly, sub, c in zip(polys, subs, planes):
            host = slice_vertices(poly.points, 1, float(c), tol=1e-6)
            if host is None:
                assert sub is None
                continue
            hits += 1
            a = np.asarray(sorted(map(tuple, np.round(
                convex_hull_prune(host), 3))))
            b = np.asarray(sorted(map(tuple, np.round(sub.points, 3))))
            assert len(a) == len(b)
            np.testing.assert_allclose(a, b, atol=2e-3)
        assert hits > 0


# -- batched planning ---------------------------------------------------------

def _random_layer(seed, n=6, v_max=8):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0, 15, (rng.integers(3, 7), 2)) for _ in range(n)]
    rv, rm = ref_slice_ops.pack_polytopes(
        [Polytope(("a", "b"), p) for p in pts], v_max=v_max)
    pv, pm = port_slice_ops.pack_polytopes(
        [PortPolytope(("a", "b"), p) for p in pts], v_max=v_max,
        device="cpu")
    return (rv, rm), (pv, pm)


def _country_crops(seed, n=64):
    """Country triangles at seeded shifts on the F320 lat/lon lattice."""
    iwc = ref_weather.IrregularWeatherCube(n_lat=640, n_lon=1280)
    tris = [p.points for name in ref_weather.COUNTRIES
            for p in iwc.country_request(name).polytopes()
            if p.axes == ("lat", "lon")]
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(tris), n)
    shift = np.stack([rng.uniform(-30, 15, n), rng.uniform(10, 300, n)], 1)
    pts = [tris[i] + shift[j] for j, i in enumerate(pick)]
    axis0 = np.sort(iwc.latitudes).astype(np.float32)
    axis1 = iwc.lon_values.astype(np.float32)
    rv, rm = ref_slice_ops.pack_polytopes(
        [Polytope(("lat", "lon"), p) for p in pts])
    pv, pm = port_slice_ops.pack_polytopes(
        [PortPolytope(("lat", "lon"), p) for p in pts], device="cpu")
    return (rv, rm), (pv, pm), axis0, axis1


def _exact(port_out, ref_out):
    for got, want in zip(port_out, ref_out):
        got = got.numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


class TestBatchedPlanning:
    @pytest.mark.parametrize("seed", range(12))
    def test_random_layers_16x16(self, seed):
        (rv, rm), (pv, pm) = _random_layer(seed)
        a16 = np.arange(16.0, dtype=np.float32)
        _exact(port_core.batched_plan_2d(pv, pm, a16, a16, 16, 16, 16, 16,
                                         device="cpu"),
               ref_batched.batched_plan_2d(rv, rm, jnp.asarray(a16),
                                           jnp.asarray(a16), 16, 16,
                                           max_rows=16, max_cols=16))
        _exact(port_core.batched_plan_runs_2d(pv, pm, a16, a16, 16,
                                              device="cpu"),
               ref_batched.batched_plan_runs_2d(rv, rm, jnp.asarray(a16),
                                                jnp.asarray(a16),
                                                max_rows=16))

    @pytest.mark.parametrize("seed", (0, 1))
    def test_country_crops_on_f320(self, seed):
        (rv, rm), (pv, pm), axis0, axis1 = _country_crops(seed)
        field = np.random.default_rng(seed).normal(
            size=axis0.size * axis1.size).astype(np.float32)
        got = port_core.batched_extract_2d(torch.from_numpy(field), pv, pm,
                                           axis0, axis1, 40, 64,
                                           device="cpu")
        want = ref_batched.batched_extract_2d(
            jnp.asarray(field), rv, rm, jnp.asarray(axis0),
            jnp.asarray(axis1), max_rows=40, max_cols=64)
        _exact(got, want)
        vals, offsets = got[0].numpy(), got[1].numpy().reshape(64, -1)
        np.testing.assert_array_equal(
            vals, np.where(offsets >= 0, field[np.maximum(offsets, 0)], 0))
        runs = port_core.batched_plan_runs_2d(pv, pm, axis0, axis1, 40,
                                              device="cpu")
        _exact(runs, ref_batched.batched_plan_runs_2d(
            rv, rm, jnp.asarray(axis0), jnp.asarray(axis1), max_rows=40,
            use_pallas=True, interpret=True))
        assert int(runs[2][2]) == int(got[2].sum()) > 0

    def test_extract_values_and_counts(self):
        """tests/test_batched.py::test_extract_values_and_counts."""
        tri = np.array([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])
        verts, valid = port_slice_ops.pack_polytopes(
            [PortPolytope(("a", "b"), tri)], v_max=4, device="cpu")
        a10 = torch.arange(10.0)
        vals, offsets, n_points = port_core.batched_extract_2d(
            torch.arange(100.0), verts, valid, a10, a10, 8, 8, device="cpu")
        assert int(n_points[0]) == 28
        got = sorted(int(v) for v, o in zip(vals[0].tolist(),
                                            offsets[0].ravel().tolist())
                     if o >= 0)
        assert got == sorted(x * 10 + y for x in range(10)
                             for y in range(10) if x + y <= 6.0000001)

    def test_padding_is_minus_one_and_zero_valued(self):
        sq = np.array([[2.0, 2.0], [3.0, 2.0], [3.0, 3.0], [2.0, 3.0]])
        verts, valid = port_slice_ops.pack_polytopes(
            [PortPolytope(("a", "b"), sq)], v_max=4, device="cpu")
        a8 = torch.arange(8.0)
        vals, offsets, n_points = port_core.batched_extract_2d(
            torch.ones(64), verts, valid, a8, a8, 4, 4, device="cpu")
        assert int(n_points[0]) == 4
        off = offsets[0].ravel()
        assert (off >= -1).all() and (vals[0][off < 0] == 0).all()

    def test_grid_past_int32_raises(self):
        (_, _), (pv, pm) = _random_layer(0)
        with pytest.raises(OverflowError, match="int32"):
            port_core.batched_plan_2d(pv, pm, torch.arange(16.0),
                                      torch.arange(16.0), 2 ** 16, 2 ** 16,
                                      4, 4, device="cpu")

    def test_entry_points_run_on_the_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        (_, _), (pv, pm) = _random_layer(0)
        a16 = torch.arange(16.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_core.batched_plan_2d(pv, pm, a16, a16, 16, 16, 16, 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_slice_ops.pack_polytopes(
                [PortPolytope(("a", "b"), np.eye(2))])
