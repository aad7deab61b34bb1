"""Layouts of polytopes for the batched crop planner's tests: the edges
of its lattice and seeded random layers, on a small grid.  Shared by the
CPU tests (``test_torch_batched_plan.py``) and the card's
(``test_torch_cuda.py``).  Needs numpy only.  Not a test module."""

from __future__ import annotations

import numpy as np

# An irregular axis 0 (the F320 latitudes are not evenly spaced either)
# and a regular axis 1; every value is exact in float32.
AXIS0 = np.array([-7.5, -6.5, -5.0, -4.5, -3.0, -2.5, -1.0, 0.0, 0.5, 1.5,
                  2.0, 3.5, 4.0, 5.5, 6.0, 7.5], np.float32)
AXIS1 = (np.arange(24) * 0.5).astype(np.float32)
TRI = np.array([[-3.2, 1.1], [2.7, 2.3], [-0.4, 6.9]], np.float32)


def _layer(polys, v_max=4):
    """Pack (points, n_valid) pairs into (P, V, 2) vertices and a mask;
    padded slots hold the first vertex, as a caller's padding may."""
    verts = np.zeros((len(polys), v_max, 2), np.float32)
    valid = np.zeros((len(polys), v_max), bool)
    for i, (pts, n_valid) in enumerate(polys):
        pts = np.asarray(pts, np.float32)
        verts[i, :len(pts)] = pts
        verts[i, len(pts):] = pts[0]
        valid[i, :n_valid] = True
    return verts, valid


def _one_eps_from(a, side):
    """The float32 value v nearest to ``a`` on ``side`` (+1 above, -1
    below) for which v - side·1e-6, rounded to float32 as the planner
    rounds it, is exactly ``a``: a polytope edge there puts the axis value
    ``a`` on its threshold."""
    f, eps = np.float32, np.float32(1e-6)
    v = f(a)
    while True:
        v = np.nextafter(v, f(side * np.inf))
        if (v - eps if side > 0 else v + eps) == f(a):
            return v


def _cases():
    sq = [[-2.5, 1.0], [1.5, 1.0], [1.5, 4.0], [-2.5, 4.0]]
    lo0, hi0 = _one_eps_from(-2.5, 1), _one_eps_from(5.5, -1)
    lo1, hi1 = _one_eps_from(2.0, 1), _one_eps_from(6.0, -1)
    return {
        # no valid vertex (its coordinates still set the scale)
        "all_invalid": (_layer([(TRI * 40, 0), (TRI, 3)]), 12, 16),
        # above, below, left of and right of the grid
        "off_grid": (_layer([(TRI + [20, 0], 3), (TRI - [30, 0], 3),
                             (TRI - [0, 20], 3), (TRI + [0, 30], 3)]),
                     12, 16),
        # the triangle runs past the last row: rows start + r >= n0
        "rows_past_n0": (_layer([(TRI + [6.0, 0], 3)]), 12, 16),
        # and past the last column: columns c_start + c >= n1
        "cols_past_n1": (_layer([(TRI + [0, 8.0], 3)]), 12, 16),
        "truncated_rows": (_layer([(TRI, 3), (TRI * 2, 3)]), 2, 30),
        "truncated_cols": (_layer([(TRI, 3), (TRI * 2, 3)]), 12, 3),
        # corners on the rows -2.5 and 1.5; a vertex on the row 0.0
        "on_plane": (_layer([(sq, 4), ([[0.0, 2.0], [3.1, 0.4],
                                        [3.3, 5.2]], 3)]), 12, 16),
        # lo0 = -2.5 and lo1 = 2.0 exactly on axis values, hi0 = 4.0 and
        # hi1 = 5.5 too
        "lo_on_axis": (_layer([([[-2.5, 2.0], [4.0, 2.0], [4.0, 5.5],
                                 [-2.5, 5.5]], 4)]), 12, 16),
        # every threshold lands on an axis value: lo0 - 1e-6 = -2.5,
        # hi0 + 1e-6 = 5.5, lo1 - 1e-6 = 2.0, hi1 + 1e-6 = 6.0
        "eps_on_axis": (_layer([([[lo0, lo1], [hi0, lo1], [hi0, hi1],
                                  [lo0, hi1]], 4)]), 12, 16),
    }


CASES = _cases()


def random_layer(seed, p=24, v=6, dtype=np.float32):
    """Random convex polygons of ``v`` vertices in order around the grid
    (some off it), each with 0 to ``v`` valid vertices; a fifth of the
    vertices lie on a row of axis 0."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform([-9, -2], [9, 13], (p, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (p, v)), axis=1)
    rad = rng.uniform(0.3, 4.0, (p, 1))
    verts = centre + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)],
                                               -1)
    verts = verts.astype(dtype)
    snap = rng.random((p, v)) < 0.2
    verts[..., 0] = np.where(snap, AXIS0[rng.integers(0, AXIS0.size,
                                                      (p, v))],
                             verts[..., 0])
    valid = np.arange(v)[None, :] < rng.integers(0, v + 1, p)[:, None]
    return verts, valid
