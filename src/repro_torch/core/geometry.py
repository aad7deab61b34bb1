"""Polytope geometry: the paper's §3.2 slicing step.

A polytope is the convex hull of a vertex set (paper §2).  We keep the
vertex representation throughout — slicing with the hyperplane
``axis = value`` is: split vertices by sign, linearly interpolate every
(below, above) pair onto the plane, keep on-plane vertices, then prune
interior points with a convex hull (QuickHull, paper §3.2 "Slicing
Step") so the vertex count does not grow quadratically slice after
slice.

Geometry planning runs on the host in float64 (exactness matters — a
vertex a hair inside/outside a plane changes which bytes are read).
The on-device variant of the same math lives in
``repro_torch.kernels.slice`` (and, as a CUDA device function, in
``csrc/slice_extents.cuh``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .hull import convex_hull_prune

# Tolerance for "vertex lies on the slicing plane".  The paper notes
# datacube indices always have gaps; 1e-9 of the axis scale is far below
# any real index spacing.
PLANE_TOL = 1e-9


@dataclass
class Polytope:
    """Convex polytope given by vertices, tagged with the axes it spans.

    ``axes``   — names of the datacube axes this polytope is defined on,
                 in datacube order (paper: "find polytopes defined on
                 axis").
    ``points`` — (V, D) float64 vertex array, D == len(axes).
    ``is_box`` — axis-aligned box fast path: slicing a box yields the
                 box without interpolation or hull pruning (the paper's
                 "performs the exact same orthogonal extractions … in
                 minimal time", made structural).
    """

    axes: tuple[str, ...]
    points: np.ndarray
    # Book-keeping for union-of-shapes provenance (paper Fig 8c).
    label: str = ""
    is_box: bool = False

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        if self.points.ndim == 1:
            self.points = self.points[:, None]
        if isinstance(self.axes, list):
            self.axes = tuple(self.axes)
        if self.points.ndim != 2 or self.points.shape[1] != len(self.axes):
            raise ValueError(
                f"points {self.points.shape} inconsistent with axes {self.axes}"
            )
        # Paper Algorithm 1 line 2: "Remove duplicate points in polytopes".
        self.points = _dedupe(self.points)

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def n_vertices(self) -> int:
        return len(self.points)

    def extents(self, axis: str) -> tuple[float, float]:
        """Min/max of the polytope along ``axis`` (Algorithm 1 line 6)."""
        k = self.axes.index(axis)
        col = self.points[:, k]
        return float(col.min()), float(col.max())

    def axis_position(self, axis: str) -> int:
        return self.axes.index(axis)

    def slice_at(self, axis: str, value: float) -> "Polytope | None":
        """Intersect with hyperplane ``axis == value``; drop that axis.

        Returns the lower-dimensional polytope on the remaining axes, or
        ``None`` when the plane misses the polytope.  This is the paper's
        §3.2 "Slicing Step" verbatim: sign split → pairwise interpolation
        → hull prune.
        """
        k = self.axes.index(axis)
        rest = tuple(a for a in self.axes if a != axis)
        if self.is_box:
            lo, hi = self.extents(axis)
            tol = PLANE_TOL * max(1.0, abs(lo), abs(hi))
            if value < lo - tol or value > hi + tol:
                return None
            if rest:
                keep = [i for i in range(len(self.axes)) if i != k]
                pts = _dedupe(self.points[:, keep])
                return Polytope(rest, pts, label=self.label,
                                is_box=True)
            return Polytope((), np.zeros((1, 0)), label=self.label)
        pts = slice_vertices(self.points, k, value)
        if pts is None:
            return None
        if rest:
            pts = convex_hull_prune(pts)
            return Polytope(rest, pts, label=self.label)
        # 0-dimensional leaf: the plane hit the final axis.
        return Polytope((), np.zeros((1, 0)), label=self.label)

    def translate(self, offset: Sequence[float]) -> "Polytope":
        return Polytope(self.axes, self.points + np.asarray(offset, np.float64),
                        label=self.label)

    def contains(self, point: Sequence[float], tol: float = 1e-9) -> bool:
        """Exact membership test (oracle for tests; not used by the slicer).

        A point is in the convex hull iff it is a convex combination of
        vertices — solved as a small LP via scipy.
        """
        from scipy.optimize import linprog

        pt = np.asarray(point, np.float64)
        V = self.points
        n = len(V)
        # minimize 0 s.t. V^T w = pt, sum w = 1, w >= 0
        A_eq = np.vstack([V.T, np.ones((1, n))])
        b_eq = np.concatenate([pt, [1.0]])
        res = linprog(np.zeros(n), A_eq=A_eq, b_eq=b_eq,
                      bounds=[(0, None)] * n, method="highs")
        if res.status == 0:
            return True
        # LP infeasibility is exact up to solver tol; retry with slack for
        # boundary points.
        if tol > 0:
            lo = pt - tol
            hi = pt + tol
            A_ub = np.vstack([V.T, -V.T])
            b_ub = np.concatenate([hi, -lo])
            res = linprog(np.zeros(n), A_ub=A_ub, b_ub=b_ub,
                          A_eq=np.ones((1, n)), b_eq=[1.0],
                          bounds=[(0, None)] * n, method="highs")
            return res.status == 0
        return False


def _dedupe(points: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """Remove duplicate vertices (Algorithm 1 line 2)."""
    if len(points) <= 1:
        return points
    if tol == 0.0:
        return np.unique(points, axis=0)
    # Tolerance-aware dedupe: round to a grid of size tol.
    keys = np.round(points / tol).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def slice_vertices(points: np.ndarray, k: int, value: float,
                   tol: float = PLANE_TOL) -> np.ndarray | None:
    """Core slicing math on a raw (V, D) vertex array.

    Returns the (V', D-1) intersection vertices (axis ``k`` removed), or
    ``None`` if the hyperplane misses the polytope.  Vectorised over all
    (below × above) vertex pairs — this is the exact routine the device
    planner's slicing core batches over many polytopes.
    """
    col = points[:, k]
    scale = max(1.0, np.abs(col).max())
    d = col - value
    on = np.abs(d) <= tol * scale
    below = d < -tol * scale
    above = d > tol * scale

    if points.shape[1] == 1:
        # 1-D polytope: the slice is a 0-D point iff the plane hits it.
        if on.any() or (below.any() and above.any()):
            return np.zeros((1, 0))
        return None

    keep = np.delete(points, k, axis=1)
    out = [keep[on]] if on.any() else []

    if below.any() and above.any():
        lo_pts, lo_d = points[below], d[below]
        hi_pts, hi_d = points[above], d[above]
        # t over all pairs: t_ij = d_lo_i / (d_lo_i - d_hi_j)  in (0, 1)
        t = lo_d[:, None] / (lo_d[:, None] - hi_d[None, :])
        lo_keep = np.delete(lo_pts, k, axis=1)
        hi_keep = np.delete(hi_pts, k, axis=1)
        interp = lo_keep[:, None, :] + t[..., None] * (
            hi_keep[None, :, :] - lo_keep[:, None, :])
        out.append(interp.reshape(-1, points.shape[1] - 1))
    if not out:
        return None
    pts = np.concatenate(out, axis=0)
    if len(pts) == 0:
        return None
    return _dedupe(pts)


def box_polytope(axes: Sequence[str], lows: Sequence[float],
                 highs: Sequence[float]) -> Polytope:
    """Axis-aligned box as a polytope (2^D corners)."""
    lows = np.asarray(lows, np.float64)
    highs = np.asarray(highs, np.float64)
    corners = np.array(list(itertools.product(*zip(lows, highs))))
    return Polytope(tuple(axes), corners, is_box=True)


def simplex_polytope(axes: Sequence[str], vertices: np.ndarray) -> Polytope:
    return Polytope(tuple(axes), vertices)


def regular_polygon(axes: Sequence[str], center: Sequence[float],
                    radius: float, n: int = 16,
                    phase: float = 0.0) -> Polytope:
    """Regular n-gon — the paper's Disk high-level shape is a polygon
    approximation of a circle (convex, so exact for the slicer)."""
    if len(axes) != 2:
        raise ValueError("regular_polygon is 2D")
    ang = phase + 2 * np.pi * np.arange(n) / n
    cx, cy = center
    pts = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], -1)
    return Polytope(tuple(axes), pts)
