"""The slicer — paper Algorithm 1.

Breadth-first over the datacube's natural axis order: per axis, find the
polytopes defined on it, read their extents, look up the discrete
indices inside the extents, add those indices to the index tree, then
slice each polytope at each index to obtain the child polytopes for the
next layer.

Faithful points:
 * BFS (FIFO frontier) — paper: "breadth-first (layer by layer) …
   ensures the algorithm does not lose track of what values inside the
   requested polytopes have already been found".
 * Categorical axes: existence check only, no slicing (paper §3.2).
 * Union requests are sliced sub-shape by sub-shape and merged in the
   index tree (paper Fig 8c measures exactly this cost).
 * Slice counting for the §5.2 bound  N_slices ≤ Σ_i Π_{j≤i} n_j.

Beyond the paper (host-side perf, see DESIGN.md §3):
 * vectorised index lookup (searchsorted, not per-index scans);
 * the final ordered axis emits **vector leaf blocks** instead of one
   node + one 1-D slice object per index — the 1-D slices the paper
   shows dominate runtime collapse into one numpy range query.

Coordinate frames (DESIGN.md §2.5): Algorithm 1 runs entirely in
**logical** coordinates — the axes the datacube presents, which for a
``TransformedDatacube`` may be cyclic (seam-straddling ranges split into
canonical in-period sub-intervals by ``CyclicAxis``), merged, or mapped.
The *positions* those axes return are already the datacube's own index
space, and ``ExtractionPlan`` offsets are resolved by the datacube in
**storage** coordinates; the slicer never converts between the two.
Both fast paths survive transforms unchanged: vector leaves delegate to
``Datacube.leaf_offsets`` (which vectorises the logical→storage map) and
shared-box slicing only touches logical geometry.

``fast_paths=False`` disables the vector-leaf and shared-box fast paths
so every index walks the per-index slicing path — the reference
executor for the fast-path parity differential suite
(tests/test_fastpath_parity.py); production callers never set it.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from .axes import CategoricalAxis, OrderedAxis
from .datacube import Datacube
from .geometry import Polytope
from .index_tree import ExtractionPlan, IndexNode, flatten
from .shapes import Request, Select


@dataclass
class SliceStats:
    """Instrumentation for the paper's §5 analysis."""

    n_slices: int = 0                      # polytope/hyperplane cuts
    n_slices_by_dim: dict[int, int] = field(default_factory=dict)
    n_points: int = 0
    slicing_time_s: float = 0.0            # time in slice_at only
    total_time_s: float = 0.0              # full Algorithm-1 walltime

    def record_slice(self, dim: int, dt: float) -> None:
        self.record_slices(dim, 1, dt)

    def record_slices(self, dim: int, n: int, dt: float) -> None:
        """Bulk recorder — the single entry point for every slicing path
        (per-index, shared-box, vector-leaf), so ``n_slices`` and
        ``n_slices_by_dim`` always agree and the §5.2 bound
        ``N_slices ≤ Σ_i Π_{j≤i} n_j`` holds by construction."""
        self.n_slices += n
        self.n_slices_by_dim[dim] = self.n_slices_by_dim.get(dim, 0) + n
        self.slicing_time_s += dt


@dataclass
class _Item:
    """Frontier entry: a partially-assigned subtree."""

    node: IndexNode
    path: dict[str, int]
    polys: list[Polytope]
    selects: list[Select]


class Slicer:
    """Algorithm 1 executor over any :class:`Datacube`."""

    def __init__(self, datacube: Datacube, fast_paths: bool = True,
                 verify: bool = False, device_planner: bool = False,
                 device=None):
        self.datacube = datacube
        self.fast_paths = fast_paths
        # verify=True runs the static plan checker
        # (repro_torch.analysis.plan_check) over every emitted plan and raises
        # on any violated invariant — the runtime hook of DESIGN.md §6.
        self.verify = verify
        # device_planner=True routes eligible requests through the fused
        # on-device pipeline (repro_torch.core.device_planner), which emits
        # byte-identical plans in one invocation instead of a host
        # round-trip per BFS layer; ineligible requests fall back to the
        # host path below transparently.  Same opt-out contract as
        # fast_paths.  Pass a DevicePlanner instance to configure the
        # backend (dtype / job cap); ``device`` places the one built
        # here (None = the card).
        self._device_planner = None
        if device_planner:
            if device_planner is True:
                from .device_planner import DevicePlanner

                self._device_planner = DevicePlanner(datacube, device=device)
            else:
                self._device_planner = device_planner

    def build_index_tree(self, request: Request,
                         lead_filter: "frozenset[int] | set[int] | None"
                         = None) -> tuple[IndexNode, SliceStats]:
        """Run Algorithm 1; with ``lead_filter`` the *root* (leading
        axis) expansion is restricted to those storage positions, so the
        delta planner (core/delta_planner.py) can re-slice exactly the
        leading-axis slabs whose intersections changed under a drift and
        splice the rest arithmetically.  Deeper levels are unaffected —
        a filtered run is byte-identical to the matching slabs of the
        unfiltered tree."""
        t0 = time.perf_counter()
        stats = SliceStats()
        root = IndexNode()
        polys = list(request.polytopes())
        selects = list(request.selects())
        frontier: deque[_Item] = deque(
            [_Item(node=root, path={}, polys=polys, selects=selects)])

        while frontier:
            item = frontier.popleft()
            axis_name = self.datacube.next_axis(item.path)
            if axis_name is None:
                item.node.complete = True
                continue
            axis = self.datacube.axis(axis_name, item.path)
            pos_filter = lead_filter if not item.path else None
            if isinstance(axis, CategoricalAxis):
                self._expand_categorical(item, axis_name, axis, frontier)
            else:
                self._expand_ordered(item, axis_name, axis, frontier,
                                     stats, pos_filter=pos_filter)

        stats.n_points = root.n_points()
        stats.total_time_s = time.perf_counter() - t0
        return root, stats

    def extract_plan(self, request: Request) -> tuple[ExtractionPlan, SliceStats]:
        if self._device_planner is not None:
            out = self._device_planner.plan(request)
            if out is not None:
                plan, stats = out
                if self.verify:
                    from repro_torch.analysis.plan_check import verify_plan

                    verify_plan(plan, datacube=self.datacube, stats=stats)
                return plan, stats
            # fall through: request/cube outside the pipeline's shape
        t0 = time.perf_counter()
        root, stats = self.build_index_tree(request)
        plan = flatten(root, self.datacube)
        stats.total_time_s = time.perf_counter() - t0
        if self.verify:
            # Lazy import: analysis is dependency-light but optional on
            # the hot path; the checker is duck-typed so no cycle forms.
            from repro_torch.analysis.plan_check import verify_plan

            verify_plan(plan, datacube=self.datacube, stats=stats)
        return plan, stats

    # -- categorical axes --------------------------------------------------
    def _expand_categorical(self, item: _Item, axis_name: str,
                            axis: CategoricalAxis,
                            frontier: deque) -> None:
        mine = [s for s in item.selects if s.axis == axis_name]
        rest = [s for s in item.selects if s.axis != axis_name]
        if not mine:
            # Implicit All — every label (paper: existence check only).
            wanted = list(enumerate(axis.values))
        else:
            # Dedupe by position: the same label twice (within or across
            # Selects) must enqueue ONE frontier item — duplicates would
            # expand the whole subtree below this node twice (the index
            # tree merges them, so the plan was right but the work and
            # slice counts silently doubled).
            wanted = []
            seen: set[int] = set()
            for sel in mine:
                for v in sel.values:
                    pos = axis.find(v)
                    if pos is not None and pos not in seen:
                        # (absent labels are silently skipped)
                        seen.add(pos)
                        wanted.append((pos, v))
        for pos, v in wanted:
            child = item.node.child(axis_name, pos, v)
            frontier.append(_Item(node=child,
                                  path={**item.path, axis_name: pos},
                                  polys=item.polys, selects=rest))

    # -- ordered axes --------------------------------------------------------
    def _expand_ordered(self, item: _Item, axis_name: str,
                        axis: OrderedAxis, frontier: deque,
                        stats: SliceStats,
                        pos_filter: "frozenset[int] | set[int] | None"
                        = None) -> None:
        mine = [p for p in item.polys if axis_name in p.axes]
        rest = [p for p in item.polys if axis_name not in p.axes]
        sel_mine = [s for s in item.selects if s.axis == axis_name]
        sel_rest = [s for s in item.selects if s.axis != axis_name]

        def narrowed(pos: np.ndarray, vals: np.ndarray):
            if pos_filter is None:
                return pos, vals
            keep = np.fromiter((int(p) in pos_filter for p in pos),
                               bool, count=len(pos))
            return pos[keep], vals[keep]

        if not mine and not sel_mine:
            # Implicit All over an ordered axis.
            pos, vals = narrowed(np.arange(len(axis)), axis.values)
            self._emit(item, axis_name, pos, vals, None, rest, sel_rest,
                       frontier, stats)
            return

        for sel in sel_mine:
            # Point selections on an ordered axis: snap to nearest index.
            pos_list, val_list = [], []
            for v in sel.values:
                p, val = axis.nearest(axis.to_float(v))
                pos_list.append(p)
                val_list.append(val)
            pos, vals = narrowed(np.asarray(pos_list, np.int64),
                                 np.asarray(val_list))
            self._emit(item, axis_name, pos, vals, None, rest, sel_rest,
                       frontier, stats)

        for poly in mine:
            # Union semantics (paper Fig 8c): each union member is sliced
            # independently; results merge in the shared children dict.
            lo, hi = poly.extents(axis_name)           # Alg.1 line 6
            pos, vals = axis.indices_in_range(lo, hi)  # Alg.1 line 7
            pos, vals = narrowed(pos, vals)
            self._emit(item, axis_name, pos, vals, poly, rest, sel_rest,
                       frontier, stats)

    def _emit(self, item: _Item, axis_name: str, pos: np.ndarray,
              vals: np.ndarray, poly: Polytope | None,
              other_polys: list[Polytope], selects: list[Select],
              frontier: deque, stats: SliceStats) -> None:
        if len(pos) == 0:
            return
        remaining_after = self.datacube.next_axis(
            {**item.path, axis_name: int(pos[0])})
        is_last_axis = remaining_after is None
        poly_dim = 0 if poly is None else poly.ndim

        if (self.fast_paths and is_last_axis and not other_polys
                and not selects and poly_dim <= 1):
            # Vector leaf fast path: these are the paper's 1-D slices —
            # emitted as one array block (counted, not materialised).
            item.node.add_leaf_block(axis_name, pos, vals)
            if poly is not None:
                stats.record_slices(1, len(pos), 0.0)
            return

        # Axis-aligned boxes slice to the same sub-box at every index
        # inside their extent — compute it once and share (turns O(points)
        # box slicing into O(nodes); boxes match the bbox baseline cost).
        # Count only when the shared slice exists: if the probe misses
        # (probe value pushed outside the box by the index-lookup
        # tolerance), the per-index path below does — and counts — the
        # slicing instead.
        shared_box = None
        if (self.fast_paths and poly is not None and poly.is_box
                and poly.ndim > 1):
            t0 = time.perf_counter()
            shared_box = poly.slice_at(axis_name,
                                       float(vals[len(vals) // 2]))
            if shared_box is not None:
                stats.record_slices(poly.ndim, len(pos),
                                    time.perf_counter() - t0)

        for p_, v_ in zip(pos, vals):
            child_polys = list(other_polys)
            if shared_box is not None:
                child_polys.append(shared_box)
            elif poly is not None and poly.ndim > 1:
                t0 = time.perf_counter()
                sub = poly.slice_at(axis_name, float(v_))   # Alg.1 line 12
                stats.record_slice(poly.ndim, time.perf_counter() - t0)
                if sub is None:
                    continue
                child_polys.append(sub)
            elif poly is not None:
                # 1-D polytope consumed by selecting this index.
                stats.record_slice(1, 0.0)
            child = item.node.child(axis_name, int(p_), float(v_))
            frontier.append(_Item(node=child,
                                  path={**item.path, axis_name: int(p_)},
                                  polys=child_polys, selects=selects))
