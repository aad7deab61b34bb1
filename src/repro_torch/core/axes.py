"""Datacube axes (paper §3.1) and axis transforms (DESIGN.md §2.5).

Two axis families:

* **Ordered axes** — comparable, interpolatable indices (floats, ints,
  datetimes).  Range queries are meaningful; the slicer slices along
  them.  Subclasses capture "special behaviours" the paper mentions —
  cyclicity (longitude) being the important one.
* **Categorical axes** — discrete labels.  Only point queries; the
  slicer merely checks existence (paper: "as would happen in every other
  traditional extraction algorithm").

Index lookup is vectorised ``searchsorted`` — this is the "more
efficient datacube look-up mechanism" the paper flags as future work
after measuring XArray lookup dominating total runtime (§5.1, Fig 8a).

**Axis transforms** generalize the index space beyond regular lattices
(the production datacube shapes of *Beyond Standard Datacubes*): a
:class:`Transform` presents one or more *storage* axes of a regular
cube as a single *logical* axis the slicer plans against — cyclic
(longitude wrap), merged (date+time → datetime), and mapped (monotone
value→index for reduced/Gaussian grids).  ``TransformedDatacube``
(core/datacube.py) owns the logical↔storage translation; transforms
only describe it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np


class Axis:
    """Base axis: a named, discrete set of indices."""

    name: str
    is_ordered: bool = False

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError


class OrderedAxis(Axis):
    """Ordered axis over sorted float-convertible indices.

    ``values`` may be irregular and sparse (paper: "indices on ordered
    axes do not have to be uniformly spaced").  Datetimes are supported
    via ``transform``/``untransform`` hooks mapping to float64 (seconds
    since epoch) — the slicer works in the transformed space, satisfying
    the paper's "measurable and linear" assumption.
    """

    is_ordered = True

    def __init__(self, name: str, values: Sequence[Any]):
        self.name = name
        self._raw = list(values)
        vals = self._to_float(np.asarray(values))
        order = np.argsort(vals, kind="stable")
        if not np.all(order[:-1] < order[1:]):
            # keep a stable position map back into storage order
            self._order = order
        else:
            self._order = None
        self._sorted = vals[order] if self._order is not None else vals
        if np.any(np.diff(self._sorted) < 0):
            raise ValueError(f"axis {name}: could not sort values")

    @staticmethod
    def _to_float(arr: np.ndarray) -> np.ndarray:
        if np.issubdtype(arr.dtype, np.datetime64):
            return arr.astype("datetime64[s]").astype(np.float64)
        return arr.astype(np.float64)

    def __len__(self) -> int:
        return len(self._sorted)

    @property
    def values(self) -> np.ndarray:
        """Axis index values in storage order, as float64."""
        if self._order is None:
            return self._sorted
        out = np.empty_like(self._sorted)
        out[self._order] = self._sorted
        return out

    @property
    def is_storage_sorted(self) -> bool:
        """True iff storage order equals ascending value order — the
        precondition for positional index arithmetic (a shift of ``s``
        index steps moves every storage position by exactly ``s``),
        which the delta planner relies on."""
        return self._order is None

    def to_float(self, value: Any) -> float:
        return float(self._to_float(np.asarray([value]))[0])

    # -- range query ----------------------------------------------------
    def indices_in_range(self, lo: float, hi: float,
                         tol: float = 1e-9) -> tuple[np.ndarray, np.ndarray]:
        """Positions (storage order) and float values inside [lo, hi].

        ``tol`` (relative to axis span) widens the interval so that
        polytope vertices that lie *exactly* on an index value are always
        captured despite float roundoff.
        """
        span = max(abs(self._sorted[0]), abs(self._sorted[-1]), 1.0)
        eps = tol * span
        i0 = int(np.searchsorted(self._sorted, lo - eps, side="left"))
        i1 = int(np.searchsorted(self._sorted, hi + eps, side="right"))
        pos = np.arange(i0, i1)
        vals = self._sorted[i0:i1]
        if self._order is not None:
            pos = self._order[i0:i1]
        return pos, vals

    def nearest(self, value: float) -> tuple[int, float]:
        i = int(np.clip(np.searchsorted(self._sorted, value), 1,
                        len(self._sorted) - 1))
        j = i if abs(self._sorted[i] - value) < abs(
            self._sorted[i - 1] - value) else i - 1
        pos = int(self._order[j]) if self._order is not None else j
        return pos, float(self._sorted[j])


class CyclicAxis(OrderedAxis):
    """Ordered axis with period ``period`` (e.g. longitude, period 360).

    Queries may cross the wrap point; ``indices_in_range`` splits the
    unwrapped query interval into in-period segments and concatenates
    results, returning *unwrapped* values so that interpolation in the
    polytope's coordinate frame stays linear (paper §3.1 "cyclicity …
    special subclasses").
    """

    def __init__(self, name: str, values: Sequence[Any], period: float):
        super().__init__(name, values)
        self.period = float(period)
        base = self._sorted
        if base[-1] - base[0] >= self.period:
            raise ValueError("axis values must span < one period")

    def indices_in_range(self, lo: float, hi: float,
                         tol: float = 1e-9) -> tuple[np.ndarray, np.ndarray]:
        if hi - lo >= self.period:  # whole circle requested
            pos = np.arange(len(self._sorted))
            if self._order is not None:
                pos = self._order[pos.astype(np.int64)]
            return pos, self._sorted.copy()
        # Shift the stored window onto the query's unwrapped frame.
        out_pos, out_val = [], []
        base_lo = self._sorted[0]
        # candidate shifts k*period placing stored values inside [lo, hi]
        k0 = int(np.floor((lo - self._sorted[-1]) / self.period))
        k1 = int(np.ceil((hi - base_lo) / self.period))
        for k in range(k0, k1 + 1):
            shift = k * self.period
            p, v = super().indices_in_range(lo - shift, hi - shift, tol)
            if len(p):
                out_pos.append(p)
                out_val.append(v + shift)
        if not out_pos:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        pos = np.concatenate(out_pos)
        val = np.concatenate(out_val)
        # A vertex exactly on the wrap point can appear twice; dedupe by pos
        # keeping first (values differ by the period — same storage cell).
        _, first = np.unique(pos, return_index=True)
        first.sort()
        return pos[first], val[first]

    def nearest(self, value: float) -> tuple[int, float]:
        """Nearest index under the cyclic metric: a point just below the
        seam snaps *across* it to the first stored value when that is
        closer (e.g. lon 359.9 → the 0.0 cell, not 359.0)."""
        base = self._sorted
        v = base[0] + (value - base[0]) % self.period
        pos, val = super().nearest(v)
        if abs(base[0] + self.period - v) < abs(val - v):
            pos = int(self._order[0]) if self._order is not None else 0
            val = float(base[0])
        return pos, val


# ---------------------------------------------------------------------------
# Axis transforms (DESIGN.md §2.5)

class Transform:
    """Protocol: present stored axes of a regular cube as one logical axis.

    ``logical_name``   — the axis name the slicer sees and requests use.
    ``storage_names``  — the consumed storage axes, in the base cube's
                         natural order (consecutive).
    ``period``         — set iff the logical axis is cyclic; consumed by
                         request canonicalization (``Datacube.axis_periods``)
                         so seam-equivalent requests share a plan-cache key.

    Logical axis *positions* address the transform's own index space;
    :meth:`storage_positions` maps them back onto each storage axis.  The
    slicer never sees storage coordinates — ``TransformedDatacube``
    applies this mapping when resolving flat offsets.
    """

    logical_name: str
    storage_names: tuple[str, ...]
    period: float | None = None

    def logical_axis(self, storage_axes: Sequence[OrderedAxis]) -> Axis:
        """Build the logical axis from the (already constructed) storage
        axes.  Called once by ``TransformedDatacube``."""
        raise NotImplementedError

    def storage_positions(self, positions: np.ndarray) -> tuple[np.ndarray, ...]:
        """Map logical positions → one position array per storage axis."""
        raise NotImplementedError


class CyclicTransform(Transform):
    """Cyclic wrap (longitude): the stored axis spans less than one
    period; logical requests may straddle the seam and are split into
    canonical in-period sub-intervals by :class:`CyclicAxis`."""

    def __init__(self, name: str, period: float,
                 storage_name: str | None = None):
        self.logical_name = name
        self.storage_names = (storage_name or name,)
        self.period = float(period)

    def logical_axis(self, storage_axes: Sequence[OrderedAxis]) -> Axis:
        (ax,) = storage_axes
        return CyclicAxis(self.logical_name, ax.values, period=self.period)

    def storage_positions(self, positions: np.ndarray) -> tuple[np.ndarray, ...]:
        return (np.asarray(positions, np.int64),)


class MergedTransform(Transform):
    """Two stored axes presented as one logical axis (date+time →
    datetime).

    Logical value at storage ``(i, j)`` is ``major[i] + minor[j]`` (both
    already in a common unit, e.g. seconds); the flattened row-major
    sequence must be strictly increasing, i.e. the major step must
    exceed the minor axis's span.  Logical position ``p`` ↔ storage
    ``(p // n_minor, p % n_minor)`` — when the pair is storage-minor
    this keeps logical leaf runs byte-contiguous.
    """

    def __init__(self, name: str, storage_names: Sequence[str]):
        if len(storage_names) != 2:
            raise ValueError("MergedTransform merges exactly two axes")
        self.logical_name = name
        self.storage_names = tuple(storage_names)
        self.period = None
        self._n_minor: int | None = None

    def logical_axis(self, storage_axes: Sequence[OrderedAxis]) -> Axis:
        major, minor = storage_axes
        vals = (np.asarray(major.values)[:, None] +
                np.asarray(minor.values)[None, :]).ravel()
        if np.any(np.diff(vals) <= 0):
            raise ValueError(
                f"merged axis {self.logical_name}: combined values must be "
                f"strictly increasing (major step must exceed minor span)")
        self._n_minor = len(minor)
        return OrderedAxis(self.logical_name, vals)

    def storage_positions(self, positions: np.ndarray) -> tuple[np.ndarray, ...]:
        if self._n_minor is None:
            raise RuntimeError("logical_axis() must be called first")
        p = np.asarray(positions, np.int64)
        return (p // self._n_minor, p % self._n_minor)


class MappedTransform(Transform):
    """Monotone value→index mapping for irregular spacings — the
    reduced/Gaussian-grid shape: storage holds plain row indices, the
    logical axis carries the physically meaningful (irregularly spaced)
    coordinates.  ``values[i]`` is the logical coordinate of storage
    position ``i`` (monotone either way; ``OrderedAxis`` keeps the
    storage-position map)."""

    def __init__(self, name: str, storage_name: str,
                 values: Sequence[float] | None = None,
                 func: Any | None = None):
        if (values is None) == (func is None):
            raise ValueError("provide exactly one of values/func")
        self.logical_name = name
        self.storage_names = (storage_name,)
        self.period = None
        self._values = None if values is None else np.asarray(values,
                                                              np.float64)
        self._func = func

    def logical_axis(self, storage_axes: Sequence[OrderedAxis]) -> Axis:
        (ax,) = storage_axes
        vals = self._values if self._values is not None else np.asarray(
            self._func(np.arange(len(ax))), np.float64)
        if len(vals) != len(ax):
            raise ValueError(
                f"mapped axis {self.logical_name}: {len(vals)} values for "
                f"{len(ax)} storage positions")
        d = np.diff(vals)
        if not (np.all(d > 0) or np.all(d < 0)):
            raise ValueError(
                f"mapped axis {self.logical_name}: mapping must be "
                f"strictly monotone")
        return OrderedAxis(self.logical_name, vals)

    def storage_positions(self, positions: np.ndarray) -> tuple[np.ndarray, ...]:
        return (np.asarray(positions, np.int64),)


class CategoricalAxis(Axis):
    """Unordered axis of distinct labels (paper: string indices etc.)."""

    is_ordered = False

    def __init__(self, name: str, values: Sequence[Any]):
        self.name = name
        self._values = list(values)
        self._lookup = {v: i for i, v in enumerate(self._values)}
        if len(self._lookup) != len(self._values):
            raise ValueError(f"axis {name}: duplicate categorical labels")

    def __len__(self) -> int:
        return len(self._values)

    @property
    def values(self) -> list:
        return list(self._values)

    def find(self, value: Any) -> int | None:
        """Position of ``value`` or None (paper: existence check only)."""
        return self._lookup.get(value)
