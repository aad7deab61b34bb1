"""Datacube abstractions (paper §3.1).

A datacube is a *possibly non-regular, imbalanced tree* of axes (paper
Fig. 2): the axis sequence below a node may depend on the index chosen
at that node.  Three concrete cubes:

* ``TensorDatacube``       — regular dense hyper-rectangle (the common case).
* ``OctahedralGridDatacube`` — ECMWF O-grid: the number of longitude
  points depends on the latitude row.  This is the real non-regular,
  imbalanced structure behind the paper's Table 1 (an O1280 field is
  6 599 680 points = "50.4 MB" at float64).
* ``BranchingDatacube``    — a leading categorical axis whose value selects
  a child cube with entirely different axes (paper Fig. 2 `val4 → x,y,z`
  vs `val5 → u,v`).
* ``TransformedDatacube``  — a regular cube viewed through axis
  transforms (cyclic/merged/mapped, DESIGN.md §2.5): the slicer plans in
  logical coordinates, offsets resolve to storage coordinates.

All cubes expose *flat element offsets*: the extraction plan ends in
byte-precise positions into the flat storage, which is exactly what the
paper's I/O layer consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Mapping, Sequence

import numpy as np

from .axes import (Axis, CategoricalAxis, CyclicAxis, OrderedAxis,
                   Transform)


class Datacube:
    """Interface used by the slicer."""

    dtype: np.dtype = np.dtype(np.float64)

    # -- cyclic metadata ---------------------------------------------------
    def axis_periods(self) -> dict[str, float]:
        """Period per cyclic *logical* axis (empty when none).

        Consumed by request canonicalization (``Request.canonical_hash``)
        so that seam-straddling requests shifted by whole periods share a
        plan-cache key (DESIGN.md §2.5).
        """
        return {}

    # -- tree navigation -------------------------------------------------
    def next_axis(self, path: Mapping[str, int]) -> str | None:
        """Name of the first unassigned axis under ``path`` (natural
        order), or None when ``path`` addresses a single element."""
        raise NotImplementedError

    def axis(self, name: str, path: Mapping[str, int]) -> Axis:
        """Axis object for ``name`` given the partial assignment.  For
        non-regular cubes the returned axis depends on ``path``."""
        raise NotImplementedError

    # -- offsets -----------------------------------------------------------
    def base_offset(self, path: Mapping[str, int]) -> int:
        """Flat element offset of the subtree addressed by ``path`` (all
        assigned axes must form a prefix of the natural order)."""
        raise NotImplementedError

    def leaf_offsets(self, path: Mapping[str, int],
                     positions: np.ndarray) -> np.ndarray:
        """Flat offsets for a vector of positions on the *last* axis."""
        return self.base_offset(path) + np.asarray(positions, np.int64)

    # -- sizes -------------------------------------------------------------
    @property
    def n_elements(self) -> int:
        raise NotImplementedError

    @property
    def nbytes(self) -> int:
        return self.n_elements * self.dtype.itemsize


class TensorDatacube(Datacube):
    """Regular dense datacube over a fixed list of axes."""

    def __init__(self, axes: Sequence[Axis], dtype=np.float64):
        self._axes = list(axes)
        self._names = tuple(a.name for a in self._axes)
        self.dtype = np.dtype(dtype)
        sizes = [len(a) for a in self._axes]
        strides = np.ones(len(sizes), np.int64)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        self._sizes = sizes
        self._strides = {n: int(s) for n, s in zip(self._names, strides)}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self._names

    def next_axis(self, path: Mapping[str, int]) -> str | None:
        for n in self._names:
            if n not in path:
                return n
        return None

    def axis(self, name: str, path: Mapping[str, int]) -> Axis:
        return self._axes[self._names.index(name)]

    def stride(self, name: str) -> int:
        return self._strides[name]

    def logical_stride(self, name: str) -> int:
        """Flat-offset increment per +1 step of ``name``'s position —
        identical to :meth:`stride` on a regular cube (the
        transform-aware spelling lives on ``TransformedDatacube``)."""
        return self._strides[name]

    def base_offset(self, path: Mapping[str, int]) -> int:
        return int(sum(self._strides[n] * p for n, p in path.items()))

    @property
    def n_elements(self) -> int:
        return int(np.prod(self._sizes)) if self._sizes else 0

    def shape(self) -> tuple[int, ...]:
        return tuple(self._sizes)

    def axis_periods(self) -> dict[str, float]:
        return {a.name: a.period for a in self._axes
                if isinstance(a, CyclicAxis)}


class OctahedralGridDatacube(Datacube):
    """ECMWF octahedral reduced-Gaussian grid O<N> with leading axes.

    Storage layout matches GRIB: fields are concatenated latitude rows,
    row ``r`` (pole-to-pole, ``2N`` rows) holding ``n_lon(r)`` points.
    Leading axes (e.g. time, level) are regular.  The longitude axis is
    *row-dependent* — the paper's non-regular imbalanced branching.
    """

    def __init__(self, leading_axes: Sequence[Axis], n: int = 1280,
                 dtype=np.float64):
        self.n = int(n)
        self._leading = list(leading_axes)
        self._lead_names = tuple(a.name for a in self._leading)
        self.dtype = np.dtype(dtype)

        # rows 0..2N-1 from north pole to south pole
        counts_north = 20 + 4 * np.arange(self.n)          # row i: 20+4i
        self.row_counts = np.concatenate([counts_north, counts_north[::-1]])
        self.row_offsets = np.concatenate(
            [[0], np.cumsum(self.row_counts)]).astype(np.int64)
        self.points_per_field = int(self.row_offsets[-1])

        # Approximate Gaussian latitudes (exactness irrelevant to byte
        # accounting; spacing matches O-grid density).
        j = np.arange(2 * self.n)
        theta = np.pi * (j + 0.5) / (2 * self.n)
        self.latitudes = 90.0 - np.degrees(theta)
        # Storage order is row order (descending latitude); OrderedAxis
        # keeps the storage-position map internally.
        self._lat_axis = OrderedAxis("lat", self.latitudes)

        lead_sizes = [len(a) for a in self._leading]
        strides = np.ones(len(lead_sizes), np.int64) * self.points_per_field
        for i in range(len(lead_sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * lead_sizes[i + 1]
        self._lead_strides = {n_: int(s) for n_, s in
                              zip(self._lead_names, strides)}
        self._lead_sizes = lead_sizes

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self._lead_names + ("lat", "lon")

    def next_axis(self, path: Mapping[str, int]) -> str | None:
        for n_ in self._lead_names:
            if n_ not in path:
                return n_
        if "lat" not in path:
            return "lat"
        if "lon" not in path:
            return "lon"
        return None

    @lru_cache(maxsize=4096)
    def _lon_axis(self, row: int) -> CyclicAxis:
        cnt = int(self.row_counts[row])
        vals = 360.0 * np.arange(cnt) / cnt
        return CyclicAxis("lon", vals, period=360.0)

    def axis(self, name: str, path: Mapping[str, int]) -> Axis:
        if name in self._lead_names:
            return self._leading[self._lead_names.index(name)]
        if name == "lat":
            return self._lat_axis
        if name == "lon":
            if "lat" not in path:
                raise ValueError("lon axis requires lat assignment")
            return self._lon_axis(int(path["lat"]))
        raise KeyError(name)

    def base_offset(self, path: Mapping[str, int]) -> int:
        off = 0
        for n_, p in path.items():
            if n_ in self._lead_strides:
                off += self._lead_strides[n_] * p
            elif n_ == "lat":
                off += int(self.row_offsets[p])
            elif n_ == "lon":
                off += int(p)
        return off

    @property
    def n_elements(self) -> int:
        lead = int(np.prod(self._lead_sizes)) if self._lead_sizes else 1
        return lead * self.points_per_field

    def field_nbytes(self) -> int:
        return self.points_per_field * self.dtype.itemsize

    def axis_periods(self) -> dict[str, float]:
        return {"lon": 360.0}


class TransformedDatacube(Datacube):
    """Logical view of a regular :class:`TensorDatacube` through axis
    transforms (DESIGN.md §2.5).

    The slicer plans entirely in **logical** coordinates — it only ever
    sees the transformed axes via :meth:`axis`/:meth:`next_axis` — while
    :meth:`base_offset`/:meth:`leaf_offsets` resolve logical paths back
    to **storage** coordinates, so ``ExtractionPlan`` offsets address
    the untransformed flat storage byte-for-byte.  This is what keeps
    the paper's exact-byte guarantee when the index space stops being a
    regular lattice: the transform layer moves the irregularity into the
    lookup, not into the plan.

    Each transform consumes one or two *consecutive* storage axes and
    replaces them, in place, with its logical axis; untouched axes pass
    through under their own names.
    """

    def __init__(self, base: TensorDatacube, transforms: Sequence[Transform]):
        self.base = base
        self.dtype = base.dtype
        by_first = {t.storage_names[0]: t for t in transforms}
        if len(by_first) != len(transforms):
            raise ValueError("transforms consume overlapping storage axes")
        base_names = base.axis_names
        names: list[str] = []
        consumed: set[str] = set()
        self._transforms: dict[str, Transform] = {}
        for i, n in enumerate(base_names):
            if n in consumed:
                continue
            t = by_first.get(n)
            if t is None:
                names.append(n)
                continue
            k = len(t.storage_names)
            if tuple(base_names[i:i + k]) != t.storage_names:
                raise ValueError(
                    f"transform {t.logical_name}: storage axes "
                    f"{t.storage_names} must be consecutive in the base "
                    f"cube's natural order {base_names}")
            names.append(t.logical_name)
            consumed.update(t.storage_names)
            self._transforms[t.logical_name] = t
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate logical axis names: {names}")
        self._logical_names = tuple(names)
        self._axes: dict[str, Axis] = {}
        for nm in names:
            t = self._transforms.get(nm)
            if t is None:
                self._axes[nm] = base.axis(nm, {})
            else:
                self._axes[nm] = t.logical_axis(
                    [base.axis(s, {}) for s in t.storage_names])

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self._logical_names

    def next_axis(self, path: Mapping[str, int]) -> str | None:
        for n in self._logical_names:
            if n not in path:
                return n
        return None

    def axis(self, name: str, path: Mapping[str, int]) -> Axis:
        return self._axes[name]

    # -- logical → storage resolution -------------------------------------
    def _storage_path(self, path: Mapping[str, int]) -> dict[str, int]:
        sp: dict[str, int] = {}
        for n, p in path.items():
            t = self._transforms.get(n)
            if t is None:
                sp[n] = p
            else:
                cols = t.storage_positions(np.asarray([p], np.int64))
                for s, col in zip(t.storage_names, cols):
                    sp[s] = int(col[0])
        return sp

    def base_offset(self, path: Mapping[str, int]) -> int:
        return self.base.base_offset(self._storage_path(path))

    def leaf_offsets(self, path: Mapping[str, int],
                     positions: np.ndarray) -> np.ndarray:
        """Vectorised logical→storage offsets for a leaf block on the
        deepest logical axis — the vector-leaf fast path stays intact
        under transforms (a merged storage-minor pair keeps logical runs
        byte-contiguous by construction)."""
        off = self.base.base_offset(self._storage_path(path))
        leaf = self.next_axis(path)
        pos = np.asarray(positions, np.int64)
        t = self._transforms.get(leaf)
        if t is None:
            return off + pos * self.base.stride(leaf)
        out = np.full(len(pos), off, np.int64)
        for s, col in zip(t.storage_names, t.storage_positions(pos)):
            out += col * self.base.stride(s)
        return out

    def logical_stride(self, name: str) -> int:
        """Flat-offset increment per +1 step of logical position on
        ``name``.  Exists (and is constant) for every transform kind:
        plain and single-storage transforms (cyclic, mapped) map
        positions identically, so the storage stride carries over; a
        merged pair's logical position ``p`` resolves to
        ``maj_stride·(p // n_minor) + min_stride·(p % n_minor)`` which,
        because the pair is consecutive in the base cube's row-major
        order (``maj_stride == n_minor·min_stride``), collapses to
        ``min_stride·p``."""
        t = self._transforms.get(name)
        if t is None:
            return self.base.stride(name)
        return self.base.stride(t.storage_names[-1])

    @property
    def n_elements(self) -> int:
        return self.base.n_elements

    def axis_periods(self) -> dict[str, float]:
        out = dict(self.base.axis_periods())
        for t in self._transforms.values():
            for s in t.storage_names:
                out.pop(s, None)
            if t.period is not None:
                out[t.logical_name] = t.period
        return out


class BranchingDatacube(Datacube):
    """Leading categorical axis selecting heterogeneous child cubes
    (paper Fig. 2)."""

    def __init__(self, axis_name: str, children: Mapping[Any, Datacube],
                 dtype=np.float64):
        self._axis_name = axis_name
        self._labels = list(children.keys())
        self._children = [children[k] for k in self._labels]
        self._axis = CategoricalAxis(axis_name, self._labels)
        self.dtype = np.dtype(dtype)
        sizes = [c.n_elements for c in self._children]
        self._bases = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def next_axis(self, path: Mapping[str, int]) -> str | None:
        if self._axis_name not in path:
            return self._axis_name
        child = self._children[path[self._axis_name]]
        sub = {k: v for k, v in path.items() if k != self._axis_name}
        return child.next_axis(sub)

    def axis(self, name: str, path: Mapping[str, int]) -> Axis:
        if name == self._axis_name:
            return self._axis
        child = self._children[path[self._axis_name]]
        sub = {k: v for k, v in path.items() if k != self._axis_name}
        return child.axis(name, sub)

    def base_offset(self, path: Mapping[str, int]) -> int:
        k = path[self._axis_name]
        child = self._children[k]
        sub = {n: v for n, v in path.items() if n != self._axis_name}
        return int(self._bases[k]) + child.base_offset(sub)

    @property
    def n_elements(self) -> int:
        return int(self._bases[-1])

    def axis_periods(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for c in self._children:
            out.update(c.axis_periods())
        return out
