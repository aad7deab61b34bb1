"""Incremental delta planning for drifting polytopes (DESIGN.md §8).

Production request streams *drift*: the same flight corridor advanced
one timestep, the same country crop for the next forecast cycle.  The
exact-match plan cache misses every one of these; the paper's §5
scaling analysis makes the resulting cold re-plan the dominant latency
for small moving selections.  This module turns a cached parent plan
plus an axis-wise integer index translation into the drifted request's
plan without re-running Algorithm 1 over the untouched slabs:

* untouched leading-axis slabs shift **arithmetically** — every flat
  offset moves by ``Σ s_ax · stride_ax`` (position arithmetic modulo
  the axis length on cyclic axes), and coordinate columns are
  recomputed from the axes' stored value arrays so they are bit-exact
  against cold planning;
* leading-axis slabs whose intersection with the request *changed*
  (entered or left the leading window) re-run the slicer, restricted to
  exactly those root positions via ``Slicer.build_index_tree``'s
  ``lead_filter``;
* §5.2 slice statistics splice additively: ``parent − dropped +
  fresh``, with the dropped slabs' counts measured by re-slicing the
  parent request narrowed to them.

The spliced plan goes through the same emission discipline as a cold
one (``index_tree.assemble_plan``: stable sort + run coalescing), so it
is byte-identical to cold planning — offsets, runs, coords, and slice
counts — which the differential suite in
``tests/test_delta_planner.py`` pins.

Eligibility is conservative and every ineligible case returns ``None``
so callers fall back to a cold plan *transparently* (same contract as
the device planner):

* the cube must be regular (``TensorDatacube`` /
  ``TransformedDatacube``) — path-independent axes with known constant
  strides;
* every shifted axis must be ordered, storage-sorted, and uniformly
  spaced, with the anchor delta an integer number of steps within the
  drift radius;
* a shifted cyclic axis must cover the full circle (``n·step ≈
  period``) and the request window must stay below one period, so the
  seam-split index lookup is translation-equivariant;
* a shifted non-cyclic, non-leading axis must keep both the old and
  new request windows strictly interior to the axis value span (no
  boundary clipping — clipping is only handled on the *leading* axis,
  where the fresh/dropped slab machinery absorbs it);
* select values on shifted axes must be numeric (labels don't
  translate).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from .axes import CyclicAxis, OrderedAxis
from .datacube import Datacube, TensorDatacube, TransformedDatacube
from .index_tree import ExtractionPlan, assemble_plan, flatten
from .shapes import Request, _is_numeric
from .slicer import Slicer, SliceStats

# |delta/step − round(delta/step)| above this is not an integer drift.
STEP_TOL = 1e-6
# Relative spacing deviation above this means the axis is not uniform.
SPACING_TOL = 1e-9


@dataclass(frozen=True)
class _AxisInfo:
    """Per-axis facts the splice arithmetic needs (probed once)."""

    stride: int                 # flat-offset increment per +1 position
    size: int
    step: float                 # uniform ascending value spacing
    scale: float                # max(|v_first|, |v_last|, 1)
    values: np.ndarray          # storage-order (ascending) float64
    cyclic: bool
    period: float               # 0.0 when not cyclic


class DeltaPlanner:
    """Splice a cached plan into its drifted neighbor's plan.

    ``max_steps`` bounds the drift radius: anchor deltas beyond that
    many index steps on any axis are treated as unrelated requests (a
    far-away clone shares no useful slab overlap, and an unbounded
    radius would let one stale parent shadow the whole axis).
    """

    def __init__(self, datacube: Datacube, slicer: Slicer | None = None,
                 max_steps: int = 64):
        self.datacube = datacube
        self.slicer = slicer if slicer is not None else Slicer(datacube)
        self.max_steps = int(max_steps)
        self._info: dict[str, _AxisInfo] = {}
        self._eligible_cube = isinstance(
            datacube, (TensorDatacube, TransformedDatacube))
        if self._eligible_cube:
            for name in datacube.axis_names:
                info = self._probe_axis(name)
                if info is not None:
                    self._info[name] = info

    # -- axis probing ------------------------------------------------------
    def _probe_axis(self, name: str) -> _AxisInfo | None:
        axis = self.datacube.axis(name, {})
        if not isinstance(axis, OrderedAxis) or not axis.is_storage_sorted:
            return None
        vals = axis.values
        n = len(vals)
        if n < 2:
            return None
        step = (float(vals[-1]) - float(vals[0])) / (n - 1)
        scale = max(abs(float(vals[0])), abs(float(vals[-1])), 1.0)
        if step <= 0 or np.max(np.abs(np.diff(vals) - step)) \
                > SPACING_TOL * scale:
            return None
        cyclic = isinstance(axis, CyclicAxis)
        period = 0.0
        if cyclic:
            period = float(axis.period)
            if abs(n * step - period) > STEP_TOL * period:
                # a partial circle clips at the seam like a boundary
                return None
        return _AxisInfo(stride=self.datacube.logical_stride(name),
                         size=n, step=step, scale=scale, values=vals,
                         cyclic=cyclic, period=period)

    # -- drift resolution --------------------------------------------------
    def axis_shifts(self, old_anchor: dict[str, float],
                    new_anchor: dict[str, float]
                    ) -> dict[str, tuple[float, int]] | None:
        """Anchor pair → per-axis ``(value delta, integer steps)``.

        Returns only axes with a nonzero integer shift; an empty dict is
        a pure sub-quantum jitter (the ``_quantize`` straddle case) and
        means the parent plan can be reused as-is.  ``None`` means the
        pair is not a splicable drift (non-uniform/unsorted axis,
        non-integer step ratio, or outside the drift radius).
        """
        if set(old_anchor) != set(new_anchor):
            return None
        shifts: dict[str, tuple[float, int]] = {}
        for ax, old_v in old_anchor.items():
            delta = new_anchor[ax] - old_v
            if delta == 0.0:
                continue
            info = self._info.get(ax)
            if info is None:
                return None
            ratio = delta / info.step
            s = int(round(ratio))
            if abs(ratio - s) > STEP_TOL:
                return None
            if info.cyclic:
                # on a full circle k steps ≡ k mod n: a drift chain that
                # wraps the seam (e.g. +189 of 192 columns) is really a
                # small backward shift — reduce to the minimal magnitude
                # so the drift radius measures actual displacement
                s %= info.size
                if s > info.size // 2:
                    s -= info.size
            if abs(s) > self.max_steps:
                return None
            if s != 0:
                shifts[ax] = (delta, s)
        return shifts

    # -- eligibility (request-dependent part) ------------------------------
    def _request_extent(self, request: Request, ax: str
                        ) -> tuple[float, float]:
        lo, hi = np.inf, -np.inf
        for p in request.polytopes():
            if ax in p.axes:
                pl, ph = p.extents(ax)
                lo, hi = min(lo, pl), max(hi, ph)
        for s in request.selects():
            if s.axis == ax:
                for v in s.values:
                    if _is_numeric(v):
                        lo, hi = min(lo, float(v)), max(hi, float(v))
        return lo, hi

    def _check_shifted_axes(self, request: Request,
                            parent_request: Request,
                            shifts: dict[str, tuple[float, int]],
                            lead_name: str) -> bool:
        for req in (request, parent_request):
            for sel in req.selects():
                if sel.axis in shifts and any(not _is_numeric(v)
                                              for v in sel.values):
                    return False
        for ax in shifts:
            info = self._info[ax]
            lo_o, hi_o = self._request_extent(parent_request, ax)
            lo_n, hi_n = self._request_extent(request, ax)
            if info.cyclic:
                # keep every window under one period minus one step so
                # the seam-split lookup never takes the full-circle (or
                # double-emission) branch, where positions stop
                # translating
                limit = info.period - abs(info.step)
                if hi_o - lo_o >= limit or hi_n - lo_n >= limit:
                    return False
            elif ax != lead_name:
                # interior check: neither window may clip at the axis
                # boundary (2× the index-lookup widening tolerance)
                eps = 2e-9 * info.scale
                if not (lo_o >= info.values[0] + eps
                        and hi_o <= info.values[-1] - eps
                        and lo_n >= info.values[0] + eps
                        and hi_n <= info.values[-1] - eps):
                    return False
        return True

    # -- leading-axis expansion (mirrors Slicer._expand_ordered) -----------
    def _lead_expansion(self, request: Request, lead_name: str
                        ) -> dict[int, float]:
        """Root-level ``position → value`` map, replicating the
        slicer's emission order (selects before polytopes, first value
        wins per position — ``IndexNode.child`` keeps the first)."""
        axis = self.datacube.axis(lead_name, {})
        exp: dict[int, float] = {}
        for sel in request.selects():
            if sel.axis != lead_name:
                continue
            for v in sel.values:
                p, val = axis.nearest(axis.to_float(v))
                exp.setdefault(int(p), float(val))
        for poly in request.polytopes():
            if lead_name not in poly.axes:
                continue
            lo, hi = poly.extents(lead_name)
            pos, vals = axis.indices_in_range(lo, hi)
            for p, v in zip(pos, vals):
                exp.setdefault(int(p), float(v))
        return exp

    # -- splicing ----------------------------------------------------------
    def splice(self, request: Request, parent_request: Request,
               parent_plan: ExtractionPlan, parent_stats: SliceStats,
               shifts: dict[str, tuple[float, int]]
               ) -> tuple[ExtractionPlan, SliceStats] | None:
        """Parent plan + drift → the drifted request's plan, or ``None``
        when any eligibility rule or internal cross-check fails (caller
        plans cold)."""
        t0 = time.perf_counter()
        if not self._eligible_cube or parent_stats is None:
            return None
        if not shifts:
            # pure sub-quantum anchor jitter: below the index-lookup
            # tolerance, so cold planning would reproduce the parent
            # plan bit-for-bit — reuse it
            stats = SliceStats(
                n_slices=parent_stats.n_slices,
                n_slices_by_dim=dict(parent_stats.n_slices_by_dim),
                n_points=parent_stats.n_points,
                total_time_s=time.perf_counter() - t0)
            return parent_plan, stats
        if any(ax not in self._info for ax in shifts):
            return None
        lead_name = self.datacube.axis_names[0]
        if not self._check_shifted_axes(request, parent_request, shifts,
                                        lead_name):
            return None

        s_lead = shifts.get(lead_name, (0.0, 0))[1]
        kept_mask = None
        lead_vals_by_pos: np.ndarray | None = None
        fresh: list[int] = []
        dropped: list[int] = []
        if s_lead:
            corr = self._lead_correspondence(request, parent_request,
                                             shifts[lead_name], lead_name)
            if corr is None:
                return None
            kept_old, lead_vals_by_pos, fresh, dropped = corr
            if len(kept_old) == 0:
                # No leading slab survives the shift: the "splice" would
                # re-slice every new slab AND re-slice every dropped slab
                # for stats — strictly more work than a cold plan.  Not
                # a delta case; let the caller plan cold.
                return None
            info = self._info[lead_name]
            lead_pos = (parent_plan.offsets // info.stride) % info.size
            kept_mask = np.isin(lead_pos, kept_old)

        if kept_mask is None:
            kept_offs = parent_plan.offsets.copy()
            kept_coords = {k: v.copy()
                           for k, v in parent_plan.coords.items()}
        else:
            kept_offs = parent_plan.offsets[kept_mask]
            kept_coords = {k: v[kept_mask]
                           for k, v in parent_plan.coords.items()}
        self._shift_points(kept_offs, kept_coords, shifts, lead_name,
                           lead_vals_by_pos)
        if len(kept_offs) and (kept_offs.min() < 0 or kept_offs.max()
                               >= self.datacube.n_elements):
            return None

        # fresh slabs: slice only the new leading positions; dropped
        # slabs: re-slice the parent request narrowed to them, for the
        # stats subtraction (their points left via kept_mask already)
        empty = (ExtractionPlan(offsets=np.empty(0, np.int64),
                                run_starts=np.empty(0, np.int64),
                                run_lengths=np.empty(0, np.int64),
                                coords={},
                                itemsize=parent_plan.itemsize),
                 SliceStats())
        fplan, fstats = empty
        if fresh:
            froot, fstats = self.slicer.build_index_tree(
                request, lead_filter=frozenset(fresh))
            fplan = flatten(froot, self.datacube)
        dstats = SliceStats()
        if dropped:
            _, dstats = self.slicer.build_index_tree(
                parent_request, lead_filter=frozenset(dropped))

        stats = self._splice_stats(parent_stats, dstats, fstats)
        if stats is None:
            return None
        # conservation cross-check: points kept must equal parent minus
        # the dropped slabs' points — any mismatch means a slab failed
        # to translate cleanly, so refuse rather than emit a wrong plan
        if len(kept_offs) != parent_plan.n_points - dstats.n_points:
            return None
        if stats.n_points != len(kept_offs) + fplan.n_points:
            return None

        offs = np.concatenate([kept_offs, fplan.offsets])
        if len(offs) == 0:
            coords: dict[str, np.ndarray] = {}
        elif fplan.n_points == 0:
            coords = kept_coords
        elif len(kept_offs) == 0:
            coords = dict(fplan.coords)
        else:
            if set(kept_coords) != set(fplan.coords):
                return None
            coords = {k: np.concatenate([kept_coords[k], fplan.coords[k]])
                      for k in kept_coords}
        plan = assemble_plan(offs, coords, parent_plan.itemsize)
        if plan.n_points != stats.n_points:
            return None
        stats.total_time_s = time.perf_counter() - t0
        return plan, stats

    def _lead_correspondence(
            self, request: Request, parent_request: Request,
            shift: tuple[float, int], lead_name: str
    ) -> "tuple[np.ndarray, np.ndarray, list[int], list[int]] | None":
        """Classify leading-axis slabs: kept (old position array), the
        new-position → value lookup for kept coords, fresh new
        positions, dropped old positions.  ``None`` when old and new
        expansions fail the value-correspondence check (the drift is
        not a clean translation at the root)."""
        delta, s = shift
        info = self._info[lead_name]
        old_exp = self._lead_expansion(parent_request, lead_name)
        new_exp = self._lead_expansion(request, lead_name)
        tol_v = max(STEP_TOL * abs(info.step), SPACING_TOL * info.scale)
        n = info.size
        kept_old: list[int] = []
        fresh: list[int] = []
        dropped: list[int] = []
        vals_by_pos = np.full(n, np.nan)
        for p, v_new in new_exp.items():
            vals_by_pos[p] = v_new
            q = (p - s) % n if info.cyclic else p - s
            v_old = old_exp.get(q)
            if v_old is None:
                fresh.append(p)
                continue
            diff = v_new - (v_old + delta)
            if info.cyclic and info.period:
                # a seam-wrapping drift reduces s mod the circle, so the
                # raw anchor delta can be off by whole periods here
                diff -= round(diff / info.period) * info.period
            if abs(diff) > tol_v:
                return None
            kept_old.append(q)
        for q in old_exp:
            p = (q + s) % n if info.cyclic else q + s
            if p not in new_exp:
                dropped.append(q)
        return (np.asarray(kept_old, np.int64), vals_by_pos, fresh,
                dropped)

    def _shift_points(self, offs: np.ndarray,
                      coords: dict[str, np.ndarray],
                      shifts: dict[str, tuple[float, int]],
                      lead_name: str,
                      lead_vals_by_pos: np.ndarray | None) -> None:
        """Apply the drift to kept points in place: integer offset
        arithmetic per shifted axis, coords recomputed from the axes'
        stored values so they are bit-exact against cold planning.

        Valid because the layout is a mixed-radix number system (the
        regular-cube eligibility): position on axis ``ax`` is
        ``(off // stride) % size`` and per-axis digit updates never
        carry — non-cyclic shifts stay in range by the interior /
        correspondence checks, cyclic shifts wrap within the digit.
        """
        if len(offs) == 0:
            return
        for ax, (delta, s) in shifts.items():
            info = self._info[ax]
            pos = (offs // info.stride) % info.size
            if info.cyclic:
                newpos = (pos + s) % info.size
                offs += (newpos - pos) * info.stride
            else:
                newpos = pos + s
                offs += s * info.stride
            if ax not in coords:
                continue
            if ax == lead_name and lead_vals_by_pos is not None:
                # exact value the cold tree assigns this root slab
                coords[ax] = lead_vals_by_pos[newpos]
            elif info.cyclic:
                # recover the unwrapped frame: the true new value is
                # old + delta up to float fuzz, and cold emits
                # stored[newpos] + k·period for an integer k
                target = coords[ax] + delta
                base = info.values[newpos]
                k = np.round((target - base) / info.period)
                coords[ax] = base + k * info.period
            else:
                coords[ax] = info.values[newpos]

    @staticmethod
    def _splice_stats(parent: SliceStats, dropped: SliceStats,
                      fresh: SliceStats) -> SliceStats | None:
        by_dim = dict(parent.n_slices_by_dim)
        for d, c in dropped.n_slices_by_dim.items():
            by_dim[d] = by_dim.get(d, 0) - c
        for d, c in fresh.n_slices_by_dim.items():
            by_dim[d] = by_dim.get(d, 0) + c
        if any(c < 0 for c in by_dim.values()):
            return None
        return SliceStats(
            n_slices=parent.n_slices - dropped.n_slices + fresh.n_slices,
            n_slices_by_dim={d: c for d, c in by_dim.items() if c},
            n_points=parent.n_points - dropped.n_points + fresh.n_points,
            slicing_time_s=fresh.slicing_time_s + dropped.slicing_time_s)
