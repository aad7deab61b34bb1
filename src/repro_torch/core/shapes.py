"""Interface levels (paper §4.1).

* low level   — :class:`ConvexPolytope`: raw vertex lists.
* high level  — :class:`Box`, :class:`Disk`, :class:`Ellipsoid`,
  :class:`Polygon` (concave OK — ear-clipped into convex triangles),
  :class:`Span`, :class:`Point`, :class:`Select`, :class:`All`, plus the
  constructive ops :class:`Union` and :class:`Path` (sweep along a
  polyline — the paper's flight-path request).
* domain level — built on these in ``repro_torch.dataplane`` (country
  extraction, time-series, vertical profiles, MRI vessels).

Every shape decomposes into convex low-level polytopes
(``.polytopes()``) and/or categorical selections (``.selects()``); the
slicer only ever sees those two primitives — "the building blocks of all
possible Polytope requests".
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from .geometry import Polytope, box_polytope, regular_polygon
from .hull import convex_hull_prune

# Quantum for canonical-form coordinate quantization (DESIGN.md §4).
# Matches the order of geometry.PLANE_TOL: two vertices closer than this
# land on the same grid cell and hash identically — datacube index
# spacing is always far coarser, so colliding requests select the same
# bytes.
CANON_TOL = 1e-9


def _quantize(arr: np.ndarray, tol: float) -> np.ndarray:
    """Snap coordinates to a grid of size ``tol`` (normalising -0.0).

    Grid snapping is inherently unstable at cell boundaries: two values
    within ``tol`` of each other can straddle a cell midpoint and land
    in adjacent cells (e.g. ``0.49·tol`` → cell 0, ``0.51·tol`` → cell
    1), so sub-tolerance-equal requests are *usually*, not *always*,
    assigned the same canonical key (pinned by the straddle regression
    test in tests/test_plan_cache.py).  Exact-match cache consumers
    tolerate this — a straddled key is only a spurious cold plan — and
    the neighborhood index recovers it: straddled anchors differ by one
    quantum, which resolves to a zero-step drift and reuses the parent
    plan (see ``repro_torch.core.delta_planner``).
    """
    q = np.round(np.asarray(arr, np.float64) / tol) * tol
    return q + 0.0


def _canon_value(v: Any, tol: float,
                 period: float | None = None) -> tuple[str, str]:
    """Order-stable key for a Select value of any hashable type."""
    if isinstance(v, (bool, str, bytes)):
        return (type(v).__name__, repr(v))
    if isinstance(v, (int, float, np.integer, np.floating)):
        # ints and equal floats must collide (axis.find treats 5 == 5.0)
        q = float(_quantize(np.array(float(v)), tol))
        if period:
            # cyclic axis: canonical representative in [0, period)
            q = float(_quantize(np.array(q - np.floor(q / period) * period),
                                tol))
        return ("f", repr(q))
    return (type(v).__name__, repr(v))


def _canon_points(p: Polytope, tol: float,
                  periods: "dict[str, float] | None") -> np.ndarray:
    """Quantized vertex array, shifted to the canonical period window.

    On each cyclic axis the polytope is translated by a whole number of
    periods so its *minimum* coordinate lands in ``[0, period)`` —
    seam-straddling requests shifted by whole periods therefore share
    one representative (and one plan-cache key), while the straddle
    itself (vertices above the period) is preserved exactly.
    """
    pts = _quantize(p.points, tol)
    if periods:
        for j, ax in enumerate(p.axes):
            period = periods.get(ax)
            if period:
                k = np.floor(pts[:, j].min() / period)
                if k:
                    pts[:, j] = _quantize(pts[:, j] - k * period, tol)
    return pts


def canonical_key(polys: Sequence[Polytope], selects: Sequence["Select"],
                  tol: float = CANON_TOL,
                  periods: "dict[str, float] | None" = None) -> tuple:
    """Canonical form of a (polytopes, selects) decomposition.

    Order-insensitive: union members and selects are sorted sets, select
    values are merged per axis (the slicer unions them anyway), and
    vertex coordinates are quantized to ``tol`` so float noise below the
    index spacing cannot split equivalent requests.  Exact duplicates
    (repeated union members, repeated select values) collapse — they
    produce the same plan.

    ``periods`` (axis → period, from ``Datacube.axis_periods``) folds
    cyclic axes: each polytope/select value is shifted by whole periods
    onto a canonical window, so period-shifted and seam-straddling
    spellings of the same request collide (DESIGN.md §2.5).
    """
    poly_keys: set[tuple] = set()
    for p in polys:
        pts = _canon_points(p, tol, periods)
        rows = tuple(sorted(set(map(tuple, pts.tolist()))))
        poly_keys.add((tuple(p.axes), rows))
    sel_vals: dict[str, set] = {}
    for s in selects:
        bucket = sel_vals.setdefault(s.axis, set())
        period = periods.get(s.axis) if periods else None
        for v in s.values:
            bucket.add(_canon_value(v, tol, period))
    sel_keys = tuple(sorted(
        (ax, tuple(sorted(vals))) for ax, vals in sel_vals.items()))
    return (tuple(sorted(poly_keys)), sel_keys)


def canonical_hash(polys: Sequence[Polytope], selects: Sequence["Select"],
                   tol: float = CANON_TOL,
                   periods: "dict[str, float] | None" = None) -> str:
    """Stable content hash of :func:`canonical_key` (process-independent:
    sha256 over the repr of nested tuples of strings/floats)."""
    key = canonical_key(polys, selects, tol, periods)
    return hashlib.sha256(repr(key).encode()).hexdigest()


def _is_numeric(v: Any) -> bool:
    """Numeric select values participate in translation (drift); bools,
    strings and other labels do not."""
    return (isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool))


def shape_signature(polys: Sequence[Polytope], selects: Sequence["Select"],
                    tol: float = CANON_TOL) -> tuple[tuple,
                                                     dict[str, float]]:
    """Translation-invariant signature of a primitive decomposition.

    The signature is the canonical form quotiented by per-axis
    translation: every vertex coordinate and numeric select value is
    expressed relative to the request's per-axis *anchor* (the minimum
    coordinate seen on that axis), then quantized exactly like
    :func:`canonical_key`.  Two requests that are translates of each
    other — the same flight corridor advanced one timestep, the same
    country crop for the next forecast cycle — therefore share a
    signature while their anchors differ by the drift vector.  The
    neighborhood index (DESIGN.md §8) keys on the signature hash and
    stores anchors separately, so a drifted request resolves to its
    parent plan and only the drift delta remains to be applied.

    No period folding is applied: translation by a whole period *is* a
    translation, so seam-shifted spellings already share a signature
    (their anchors differ by the period, which the delta planner reduces
    modulo the axis length).

    Returns ``(signature_key, anchor)`` with ``anchor`` holding the raw
    (unquantized) per-axis minima — the delta planner needs exact floats
    to recover integer index steps; quantization noise is absorbed by
    its integer-step tolerance.
    """
    anchor: dict[str, float] = {}
    for p in polys:
        for j, ax in enumerate(p.axes):
            m = float(p.points[:, j].min())
            anchor[ax] = min(anchor.get(ax, m), m)
    for s in selects:
        for v in s.values:
            if _is_numeric(v):
                f = float(v)
                anchor[s.axis] = min(anchor.get(s.axis, f), f)

    poly_keys: set[tuple] = set()
    for p in polys:
        a = np.array([anchor[ax] for ax in p.axes], np.float64)
        pts = _quantize(p.points - a, tol)
        rows = tuple(sorted(set(map(tuple, pts.tolist()))))
        poly_keys.add((tuple(p.axes), rows))
    sel_vals: dict[str, set] = {}
    for s in selects:
        bucket = sel_vals.setdefault(s.axis, set())
        for v in s.values:
            if _is_numeric(v):
                q = float(_quantize(np.array(float(v) - anchor[s.axis]),
                                    tol))
                bucket.add(("f", repr(q)))
            else:
                bucket.add(_canon_value(v, tol))
    sel_keys = tuple(sorted(
        (ax, tuple(sorted(vals))) for ax, vals in sel_vals.items()))
    return (tuple(sorted(poly_keys)), sel_keys), anchor


def signature_hash(polys: Sequence[Polytope], selects: Sequence["Select"],
                   tol: float = CANON_TOL) -> tuple[str, dict[str, float]]:
    """Stable sha256 of :func:`shape_signature`'s key, plus the anchor."""
    key, anchor = shape_signature(polys, selects, tol)
    return hashlib.sha256(repr(key).encode()).hexdigest(), anchor


class Shape:
    def polytopes(self) -> list[Polytope]:
        return []

    def selects(self) -> list["Select"]:
        return []

    def canonical_key(self, tol: float = CANON_TOL,
                      periods: dict[str, float] | None = None) -> tuple:
        """Canonical form of this shape's primitive decomposition."""
        return canonical_key(self.polytopes(), self.selects(), tol, periods)

    def canonical_hash(self, tol: float = CANON_TOL,
                       periods: dict[str, float] | None = None) -> str:
        return canonical_hash(self.polytopes(), self.selects(), tol, periods)


@dataclass
class Select(Shape):
    """Specific index values — the only legal query on categorical axes;
    also usable on ordered axes (snaps to nearest index)."""

    axis: str
    values: Sequence[Any]

    def selects(self) -> list["Select"]:
        return [self]


@dataclass
class All(Shape):
    """Everything on an axis (an unconstrained axis behaves the same)."""

    axis: str

    def polytopes(self) -> list[Polytope]:
        big = 1e30
        return [Polytope((self.axis,), np.array([[-big], [big]]))]


@dataclass
class Span(Shape):
    """1-D interval on an ordered axis."""

    axis: str
    lo: float
    hi: float

    def polytopes(self) -> list[Polytope]:
        return [Polytope((self.axis,), np.array([[self.lo], [self.hi]],
                                                np.float64))]


@dataclass
class Point(Shape):
    """Exact point on ordered axes (degenerate polytope)."""

    axes: Sequence[str]
    coords: Sequence[float]

    def polytopes(self) -> list[Polytope]:
        return [Polytope(tuple(self.axes),
                         np.asarray([self.coords], np.float64))]


@dataclass
class Box(Shape):
    axes: Sequence[str]
    lows: Sequence[float]
    highs: Sequence[float]

    def polytopes(self) -> list[Polytope]:
        return [box_polytope(self.axes, self.lows, self.highs)]


@dataclass
class ConvexPolytope(Shape):
    """Low-level interface: explicit convex vertex list."""

    axes: Sequence[str]
    vertices: np.ndarray

    def polytopes(self) -> list[Polytope]:
        return [Polytope(tuple(self.axes), np.asarray(self.vertices,
                                                      np.float64))]


@dataclass
class Disk(Shape):
    """2-D disk, approximated by a regular n-gon (convex, slicer-exact)."""

    axes: Sequence[str]
    center: Sequence[float]
    radius: float | Sequence[float]
    segments: int = 32

    def polytopes(self) -> list[Polytope]:
        r = self.radius
        rx, ry = (r, r) if np.isscalar(r) else r
        ang = 2 * np.pi * np.arange(self.segments) / self.segments
        cx, cy = self.center
        pts = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], -1)
        return [Polytope(tuple(self.axes), pts)]


@dataclass
class Ellipsoid(Shape):
    """3-D ellipsoid approximated by a convex point shell."""

    axes: Sequence[str]
    center: Sequence[float]
    radii: Sequence[float]
    rings: int = 8
    segments: int = 16

    def polytopes(self) -> list[Polytope]:
        cx, cy, cz = self.center
        rx, ry, rz = self.radii
        pts = []
        for i in range(1, self.rings):
            phi = np.pi * i / self.rings
            for j in range(self.segments):
                th = 2 * np.pi * j / self.segments
                pts.append([cx + rx * np.sin(phi) * np.cos(th),
                            cy + ry * np.sin(phi) * np.sin(th),
                            cz + rz * np.cos(phi)])
        pts.append([cx, cy, cz + rz])
        pts.append([cx, cy, cz - rz])
        return [Polytope(tuple(self.axes), np.asarray(pts))]


@dataclass
class Polygon(Shape):
    """Simple (possibly concave) 2-D polygon → convex triangles via
    ear clipping.  This is how country shapes enter the slicer; the
    paper's interface "is responsible for decomposing all user request
    shapes into these base convex polytopes"."""

    axes: Sequence[str]
    points: np.ndarray  # (N, 2) boundary, any winding, not self-crossing

    def polytopes(self) -> list[Polytope]:
        tris = ear_clip(np.asarray(self.points, np.float64))
        return [Polytope(tuple(self.axes), t, label="tri") for t in tris]


@dataclass
class Union(Shape):
    """Union of sub-shapes on the same axes (paper Fig 8c)."""

    shapes: Sequence[Shape]

    def polytopes(self) -> list[Polytope]:
        return [p for s in self.shapes for p in s.polytopes()]

    def selects(self) -> list[Select]:
        return [q for s in self.shapes for q in s.selects()]


@dataclass
class Path(Shape):
    """Sweep a convex base shape along a polyline (flight path, MRI
    vessel centreline).  Each segment's sweep is the convex hull of the
    base placed at both endpoints — convex per segment, union overall."""

    axes: Sequence[str]
    base: Shape                     # shape on a subset/all of `axes`
    waypoints: np.ndarray           # (K, len(axes)) polyline vertices

    def polytopes(self) -> list[Polytope]:
        wps = np.asarray(self.waypoints, np.float64)
        base_polys = self.base.polytopes()
        out = []
        for bp in base_polys:
            # embed base vertices into the full axis space (zero-padded on
            # axes the base does not constrain)
            D = len(self.axes)
            emb = np.zeros((bp.n_vertices, D))
            for j, ax in enumerate(bp.axes):
                emb[:, self.axes.index(ax)] = bp.points[:, j]
            for a, b in zip(wps[:-1], wps[1:]):
                seg = np.concatenate([emb + a, emb + b], axis=0)
                seg = convex_hull_prune(seg)
                out.append(Polytope(tuple(self.axes), seg, label="sweep"))
        return out


@dataclass
class Request:
    """A full query: shapes over disjoint axis sets; their product is the
    requested region.  Uncovered axes default to All."""

    shapes: Sequence[Shape]

    def polytopes(self) -> list[Polytope]:
        """Primitive decomposition, memoized per Request object.

        Triangulating a concave polygon (ear-clipping) dominates the
        cost and the decomposition is consumed repeatedly — canonical
        hash, shape signature, extent probes and the slicer all start
        here.  Mutating ``shapes`` after the first call is not
        supported (the same contract as :meth:`canonical_hash`).
        Callers must not mutate the returned list.
        """
        polys = self.__dict__.get("_polytopes")
        if polys is None:
            polys = [p for s in self.shapes for p in s.polytopes()]
            self.__dict__["_polytopes"] = polys
        return polys

    def selects(self) -> list[Select]:
        return [q for s in self.shapes for q in s.selects()]

    def covered_axes(self) -> set[str]:
        axes: set[str] = set()
        for p in self.polytopes():
            axes |= set(p.axes)
        for s in self.selects():
            axes.add(s.axis)
        return axes

    def canonical_form(self, tol: float = CANON_TOL,
                       periods: dict[str, float] | None = None) -> tuple:
        """Order-insensitive, tolerance-quantized canonical form.

        Two requests with equal canonical forms select the same datacube
        bytes (same primitive decomposition up to member order, select
        order/duplication, and sub-``tol`` coordinate noise), so their
        extraction plans are interchangeable — the plan cache's key
        (DESIGN.md §4).  With ``periods`` (from
        ``Datacube.axis_periods``) requests on cyclic axes are
        additionally normalized modulo the period, so seam-straddling
        requests shifted by whole periods collide too (DESIGN.md §2.5).
        """
        return canonical_key(self.polytopes(), self.selects(), tol, periods)

    def canonical_hash(self, tol: float = CANON_TOL,
                       periods: dict[str, float] | None = None) -> str:
        """Stable sha256 content hash of :meth:`canonical_form`.

        Memoized per Request object (decomposition — e.g. ear-clipping a
        country polygon — dominates the hash cost; a served request is
        hashed exactly once).  Mutating ``shapes`` after the first call
        is not supported.
        """
        pkey = tuple(sorted(periods.items())) if periods else ()
        cache = self.__dict__.setdefault("_canon_hashes", {})
        h = cache.get((tol, pkey))
        if h is None:
            h = canonical_hash(self.polytopes(), self.selects(), tol,
                               periods)
            cache[(tol, pkey)] = h
        return h

    def shape_signature(self, tol: float = CANON_TOL
                        ) -> tuple[str, dict[str, float]]:
        """Translation-invariant signature hash + per-axis anchor.

        Memoized like :meth:`canonical_hash` (the decomposition
        dominates); the anchor dict is shared, callers must not mutate
        it.  Drifted requests share the hash; their anchors differ by
        the drift vector (see :func:`shape_signature`).
        """
        cache = self.__dict__.setdefault("_sig_cache", {})
        out = cache.get(tol)
        if out is None:
            out = signature_hash(self.polytopes(), self.selects(), tol)
            cache[tol] = out
        return out


# ---------------------------------------------------------------------------
def ear_clip(poly: np.ndarray) -> list[np.ndarray]:
    """Triangulate a simple polygon (ear clipping, O(n^2))."""
    pts = list(range(len(poly)))
    if len(pts) < 3:
        raise ValueError("polygon needs >= 3 points")
    # enforce CCW
    if _signed_area(poly) < 0:
        pts = pts[::-1]
    tris: list[np.ndarray] = []
    guard = 0
    while len(pts) > 3 and guard < 10 * len(poly) ** 2:
        guard += 1
        n = len(pts)
        clipped = False
        for i in range(n):
            a, b, c = pts[(i - 1) % n], pts[i], pts[(i + 1) % n]
            pa, pb, pc = poly[a], poly[b], poly[c]
            if _cross(pb - pa, pc - pb) <= 1e-14:   # reflex or degenerate
                continue
            tri = np.array([pa, pb, pc])
            if any(_point_in_tri(poly[q], tri) for q in pts
                   if q not in (a, b, c)):
                continue
            tris.append(tri)
            pts.pop(i)
            clipped = True
            break
        if not clipped:     # numerically stuck: emit fan and stop
            break
    if len(pts) >= 3:
        anchor = pts[0]
        for i in range(1, len(pts) - 1):
            tris.append(np.array([poly[anchor], poly[pts[i]],
                                  poly[pts[i + 1]]]))
    return tris


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _cross(u: np.ndarray, v: np.ndarray) -> float:
    return float(u[0] * v[1] - u[1] * v[0])


def _point_in_tri(p: np.ndarray, tri: np.ndarray) -> bool:
    a, b, c = tri
    d1 = _cross(b - a, p - a)
    d2 = _cross(c - b, p - b)
    d3 = _cross(a - c, p - c)
    neg = (d1 < -1e-14) or (d2 < -1e-14) or (d3 < -1e-14)
    pos = (d1 > 1e-14) or (d2 > 1e-14) or (d3 > 1e-14)
    return not (neg and pos)
