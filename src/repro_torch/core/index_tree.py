"""Index tree (paper §3.2 "Index Tree Construction") and extraction plans.

The slicer builds the tree breadth-first; interior levels are Python
nodes (few — one per selected index on the *upper* axes), while the
deepest ordered axis stores its selected indices as **vector leaf
blocks** (positions + values arrays).  This is the host-side analogue of
the paper's observation that 1-D slices dominate: we never materialise
them as objects, we emit them as arrays.

Flattening a tree yields an :class:`ExtractionPlan`: flat element
offsets into the datacube storage (the "precise bytes"), coalesced into
contiguous ``(start, length)`` runs for burst-friendly I/O, plus the
coordinates of every extracted point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .datacube import Datacube


@dataclass
class IndexNode:
    """One selected index on one axis."""

    axis: str | None = None          # None for the root
    pos: int = -1                    # storage position on the axis
    value: Any = None                # axis value (unwrapped for cyclic)
    children: dict[int, "IndexNode"] = field(default_factory=dict)
    # Vector leaf block: selected positions/values on the *next* axis.
    leaf_axis: str | None = None
    leaf_positions: np.ndarray | None = None
    leaf_values: np.ndarray | None = None
    # True iff this node's path addresses a single datacube element.  A
    # node with no children, no leaf block and complete=False is a
    # *dangling* branch (all its candidate children were sliced away) and
    # contributes nothing.
    complete: bool = False

    def child(self, axis: str, pos: int, value: Any) -> "IndexNode":
        node = self.children.get(pos)
        if node is None:
            node = IndexNode(axis=axis, pos=pos, value=value)
            self.children[pos] = node
        return node

    def add_leaf_block(self, axis: str, positions: np.ndarray,
                       values: np.ndarray) -> None:
        if self.leaf_positions is None:
            self.leaf_axis = axis
            self.leaf_positions = np.asarray(positions, np.int64)
            self.leaf_values = np.asarray(values, np.float64)
        else:
            # Union merge (paper Fig 8c): concatenate then dedupe by pos.
            pos = np.concatenate([self.leaf_positions, positions])
            val = np.concatenate([self.leaf_values, values])
            _, first = np.unique(pos, return_index=True)
            first.sort()
            self.leaf_positions = pos[first].astype(np.int64)
            self.leaf_values = val[first]

    # -- stats ------------------------------------------------------------
    def n_points(self) -> int:
        n = 0 if self.leaf_positions is None else len(self.leaf_positions)
        if self.complete:
            n += 1
        return n + sum(c.n_points() for c in self.children.values())

    def depth(self) -> int:
        d = 1 if self.leaf_positions is not None else 0
        if self.children:
            d = max(d, 1 + max(c.depth() for c in self.children.values()))
        return d


@dataclass
class ExtractionPlan:
    """The paper's output: the precise elements to read."""

    offsets: np.ndarray                    # (N,) int64 flat element offsets
    run_starts: np.ndarray                 # (R,) int64
    run_lengths: np.ndarray                # (R,) int64
    coords: dict[str, np.ndarray]          # axis -> (N,) values
    itemsize: int = 8

    @property
    def n_points(self) -> int:
        return int(len(self.offsets))

    @property
    def nbytes(self) -> int:
        """Bytes this plan reads — the paper's headline metric."""
        return self.n_points * self.itemsize

    @property
    def n_runs(self) -> int:
        return int(len(self.run_starts))


def flatten(root: IndexNode, datacube: Datacube) -> ExtractionPlan:
    """Walk the tree and emit the extraction plan (vectorised leaves)."""
    offsets: list[np.ndarray] = []
    coord_cols: dict[str, list[np.ndarray]] = {}

    def walk(node: IndexNode, path: dict[str, int],
             coord: dict[str, Any]) -> None:
        if node.leaf_positions is not None:
            n = len(node.leaf_positions)
            offs = datacube.leaf_offsets(path, node.leaf_positions)
            offsets.append(offs.astype(np.int64))
            for ax_name, v in coord.items():
                coord_cols.setdefault(ax_name, []).append(np.full(n, v))
            coord_cols.setdefault(node.leaf_axis, []).append(
                np.asarray(node.leaf_values))
        if node.complete:  # fully-assigned scalar leaf
            offsets.append(np.array([datacube.base_offset(path)], np.int64))
            for ax_name, v in coord.items():
                coord_cols.setdefault(ax_name, []).append(np.array([v]))
        if not node.children:
            return
        for child in node.children.values():
            path[child.axis] = child.pos
            coord[child.axis] = child.value
            walk(child, path, coord)
            del path[child.axis]
            del coord[child.axis]

    walk(root, {}, {})

    if offsets:
        offs = np.concatenate(offsets)
    else:
        offs = np.empty(0, np.int64)
    coords = {}
    n_total = len(offs)
    for ax_name, cols in coord_cols.items():
        col = np.concatenate(cols)
        if len(col) == n_total:
            coords[ax_name] = col
    return assemble_plan(offs, coords, datacube.dtype.itemsize)


def assemble_plan(offs: np.ndarray, coords: dict[str, np.ndarray],
                  itemsize: int) -> ExtractionPlan:
    """Sort, coalesce and wrap raw (offsets, coords) into a plan.

    Plans are emitted in ascending storage order: runs become ascending
    burst reads and sortedness is a checkable invariant
    (repro_torch.analysis.plan_check).  Tree-walk order is *almost* storage
    order already, but e.g. a seam-straddling cyclic range emits the
    wrapped sub-interval after the unwrapped one; the coordinate
    columns are permuted in lockstep so point↔coord pairing is intact.
    Shared by :func:`flatten` and the delta planner's splice path
    (core/delta_planner.py), so a spliced plan goes through the exact
    emission discipline of a cold one.
    """
    n_total = len(offs)
    order = np.argsort(offs, kind="stable")
    if not np.array_equal(order, np.arange(n_total)):
        offs = offs[order]
        coords = {k: v[order] for k, v in coords.items()}
    starts, lengths = coalesce_runs(offs)
    return ExtractionPlan(offsets=offs, run_starts=starts,
                          run_lengths=lengths, coords=coords,
                          itemsize=itemsize)


def coalesce_runs(offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge consecutive offsets into (start, length) runs.

    The deepest ordered axis is storage-minor in all our cubes, so the
    plan's offsets arrive largely presorted in contiguous stretches —
    these become long burst reads (paper §5.4: hardware with fast
    random read benefits; HBM wants bursts).
    """
    if len(offsets) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    brk = np.flatnonzero(np.diff(offsets) != 1)
    starts_idx = np.concatenate([[0], brk + 1])
    ends_idx = np.concatenate([brk, [len(offsets) - 1]])
    return offsets[starts_idx].copy(), (ends_idx - starts_idx + 1).astype(
        np.int64)


@dataclass
class CompressedPlan:
    """Delta-encoded int32 plan: the wire/cache form of the run list.

    A sorted, deduplicated plan's runs are strictly ascending and
    non-overlapping, so ``start[i] − (start[i−1] + length[i−1]) ≥ 1``
    for every i > 0 — the *gaps* between runs are small positive
    integers even when absolute offsets approach 2⁶³.  Store one int64
    anchor plus int32 gap/length columns: 8 + 8·R bytes instead of the
    plan's 8·N offsets, a ~N/R · 2 compression on burst-friendly plans.

    ``compress_plan`` validates every column through
    ``checked_cast_i32`` — a gap or length past 2³¹ raises
    ``OverflowError`` instead of truncating, and the caller keeps the
    uncompressed plan (host fallback).
    """

    base: int                              # int64 anchor: first run start
    start_gaps: np.ndarray                 # (R,) int32; gaps[0] == 0
    run_lengths: np.ndarray                # (R,) int32
    itemsize: int = 8

    @property
    def n_runs(self) -> int:
        return int(len(self.run_lengths))

    @property
    def n_points(self) -> int:
        return int(self.run_lengths.sum()) if self.n_runs else 0

    @property
    def nbytes_encoded(self) -> int:
        """Size of the encoded form itself (anchor + two i32 columns)."""
        return 8 + 8 * self.n_runs


def compress_plan(plan: ExtractionPlan) -> CompressedPlan:
    """Delta-encode a plan's runs into :class:`CompressedPlan`."""
    from repro_torch.kernels._casting import checked_cast_i32

    starts = np.asarray(plan.run_starts, np.int64)
    lengths = np.asarray(plan.run_lengths, np.int64)
    if len(starts) == 0:
        empty = np.empty(0, np.int32)
        return CompressedPlan(base=0, start_gaps=empty, run_lengths=empty,
                              itemsize=plan.itemsize)
    gaps = np.concatenate([[0], starts[1:] - (starts[:-1] + lengths[:-1])])
    if np.any(gaps[1:] <= 0):
        raise ValueError("plan runs are not sorted/disjoint — cannot "
                         "delta-encode (run flatten/coalesce first)")
    return CompressedPlan(
        base=int(starts[0]),
        start_gaps=np.asarray(checked_cast_i32(
            gaps, what="compressed plan start gaps")),
        run_lengths=np.asarray(checked_cast_i32(
            lengths, what="compressed plan run lengths")),
        itemsize=plan.itemsize)


def decompress_plan(cp: CompressedPlan) -> ExtractionPlan:
    """Exact inverse of :func:`compress_plan` (offsets re-expanded)."""
    lengths = cp.run_lengths.astype(np.int64)
    if len(lengths) == 0:
        e = np.empty(0, np.int64)
        return ExtractionPlan(offsets=e, run_starts=e.copy(),
                              run_lengths=e.copy(), coords={},
                              itemsize=cp.itemsize)
    starts = (cp.base + np.cumsum(cp.start_gaps.astype(np.int64))
              + np.concatenate([[0], np.cumsum(lengths[:-1])]))
    ends = np.cumsum(lengths)
    total = int(ends[-1])
    offsets = (np.repeat(starts, lengths)
               + np.arange(total, dtype=np.int64)
               - np.repeat(ends - lengths, lengths))
    return ExtractionPlan(offsets=offsets, run_starts=starts,
                          run_lengths=lengths, coords={},
                          itemsize=cp.itemsize)
