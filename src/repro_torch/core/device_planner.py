"""Device-resident planner: Algorithm 1 as one fused pipeline invocation.

``DevicePlanner`` is the host adapter around ``repro_torch.kernels.plan``: it
resolves the *leading* axes of a request exactly the way ``Slicer``
does (selects, implicit Alls, 1-D spans — cheap python over small
axes), then hands every (leading-path × trailing-polytope) job to the
fused pipeline, which runs the expensive trailing-2-D stage — row
discovery, per-row slicing, column ranges, run emission — in a single
device invocation instead of a host round-trip per BFS layer.

Parity contract: the emitted plan is byte-identical to the host
planner's (``Slicer(fast_paths=False)`` per-index reference, and the
default fast-path planner wherever the two agree) — every comparison
and interpolation in the pipeline mirrors the host formulas
operation-for-operation, and the pipeline runs in float64 by default
(pass ``dtype=np.float32`` for the approximate single-precision mode).
On a CUDA device the pipeline is the hand-written kernel B3
(``csrc/plan_runs_2d.cu``); with ``device="cpu"`` it is the plain
PyTorch version.  ``SliceStats`` accounting (§5.2) is
reproduced exactly: dim-2 slices = candidate rows, dim-1 slices =
leading span indices + emitted leaf points pre-dedupe.

Device plans carry ``coords={}``: the gather path consumes offsets and
runs only, and skipping per-point coordinate labels is part of why the
device path is fast.  Callers needing labelled points use the host
planner.

``plan()`` returns ``None`` whenever the request or cube falls outside
the pipeline's shape (non-trailing 2-D polytopes, cyclic major axis,
non-contiguous minor storage, duplicate frontier positions, > 2³¹
elements, fan-out past ``max_jobs``) — the ``Slicer`` entry point then
falls back to the host path transparently, the same opt-out contract as
``fast_paths``.
"""

from __future__ import annotations

import itertools
import time
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..kernels._casting import checked_cast_i32
from .axes import CategoricalAxis, CyclicAxis, OrderedAxis
from .datacube import Datacube, TensorDatacube, TransformedDatacube
from .geometry import PLANE_TOL
from .index_tree import ExtractionPlan, coalesce_runs
from .shapes import Request
from .slicer import SliceStats

I32_LIMIT = 2 ** 31
MAX_JOBS = 4096
LOOKUP_TOL = 1e-9   # OrderedAxis.indices_in_range default tol


def _lookup_eps(ax: OrderedAxis) -> float:
    sv = ax._sorted
    return LOOKUP_TOL * max(abs(float(sv[0])), abs(float(sv[-1])), 1.0)


def _row_count(sv0: np.ndarray, eps0: float, poly, major: str) -> int:
    lo, hi = poly.extents(major)
    i0 = int(np.searchsorted(sv0, lo - eps0, side="left"))
    i1 = int(np.searchsorted(sv0, hi + eps0, side="right"))
    return max(i1 - i0, 0)


class DevicePlanner:
    """Fused-pipeline planner with transparent host fallback."""

    def __init__(self, datacube: Datacube, device=None, dtype=np.float64,
                 max_jobs: int = MAX_JOBS, *, use_pallas: bool = False):
        """``device=None`` means the card (raises when there is none);
        ``device="cpu"`` runs the plain PyTorch pipeline.  ``use_pallas``
        keeps the JAX package's flag for parity and is ignored: the
        device decides whether the CUDA kernel runs."""
        self.datacube = datacube
        self.device = resolve_device(device)
        self.use_pallas = use_pallas
        self.dtype = np.dtype(dtype)
        self.max_jobs = max_jobs
        self._grid: dict[str, Any] | None | bool = False  # False = unprobed
        self._tables: tuple[torch.Tensor, ...] | None = None

    # -- cube eligibility (static, cached) --------------------------------
    def _prepare_grid(self) -> dict[str, Any] | None:
        dc = self.datacube
        # Only cubes whose axis walk is path-independent: the octahedral
        # and branching cubes interleave axis *shape* with the path, so
        # the fixed (n0, n1) trailing lattice does not exist for them.
        if not isinstance(dc, (TensorDatacube, TransformedDatacube)):
            return None
        if dc.n_elements >= I32_LIMIT:
            return None   # run starts must fit the i32 plan buffer
        names = dc.axis_names
        if len(names) < 2:
            return None
        axes = {n: dc.axis(n, {}) for n in names}
        major, minor = names[-2], names[-1]
        ax0, ax1 = axes[major], axes[minor]
        # Cyclic major would need the two-segment wrap per *row block*,
        # not per row — host planner handles it; we fall back.
        if not isinstance(ax0, OrderedAxis) or isinstance(ax0, CyclicAxis):
            return None
        if not isinstance(ax1, OrderedAxis) or ax1._order is not None:
            return None

        # Minor axis must be unit-stride and identity-ordered in storage
        # so column ranges are byte runs.
        n1 = len(ax1)
        if isinstance(dc, TensorDatacube):
            if dc.stride(minor) != 1:
                return None
        else:
            t1 = dc._transforms.get(minor)
            sname = minor if t1 is None else t1.storage_names[-1]
            if t1 is not None:
                if len(t1.storage_names) != 1:
                    return None
                probe = np.arange(n1, dtype=np.int64)
                cols = t1.storage_positions(probe)
                if len(cols) != 1 or not np.array_equal(cols[0], probe):
                    return None
            if dc.base.stride(sname) != 1:
                return None

        # Per-sorted-row storage offsets through permutation + transform.
        n0 = len(ax0)
        perm0 = (ax0._order.astype(np.int64) if ax0._order is not None
                 else np.arange(n0, dtype=np.int64))
        if isinstance(dc, TensorDatacube):
            rowoff = perm0 * dc.stride(major)
        else:
            t0 = dc._transforms.get(major)
            if t0 is None:
                rowoff = perm0 * dc.base.stride(major)
            else:
                rowoff = np.zeros(n0, np.int64)
                cols = t0.storage_positions(perm0)
                for s, col in zip(t0.storage_names, cols):
                    rowoff += col.astype(np.int64) * dc.base.stride(s)

        return {
            "lead": names[:-2], "major": major, "minor": minor,
            "axes": axes,
            "sv0": np.asarray(ax0._sorted, np.float64),
            "sv1": np.asarray(ax1._sorted, np.float64),
            "rowoff": rowoff, "n0": n0, "n1": n1,
            "eps0": _lookup_eps(ax0), "eps1": _lookup_eps(ax1),
            "cyclic": isinstance(ax1, CyclicAxis),
            "period": float(ax1.period) if isinstance(ax1, CyclicAxis)
            else 0.0,
        }

    # -- request eligibility + leading-axis resolution --------------------
    def _resolve_leading(self, g: dict[str, Any], request: Request):
        """Mirror Slicer's leading-axis expansion; None = fall back.

        Returns (levels, dim1_lead, empty): ``levels`` is the per-axis
        position list in BFS order, ``dim1_lead`` the host planner's
        dim-1 slice count for leading 1-D spans (multiplied by the
        frontier fan-in at that depth), ``empty`` flags a dead frontier.
        """
        polys = list(request.polytopes())
        selects = list(request.selects())
        polys2 = [p for p in polys if p.ndim == 2]
        if not polys2:
            return None
        for p in polys2:
            if set(p.axes) != {g["major"], g["minor"]}:
                return None
        lead = g["lead"]
        for s in selects:
            if s.axis not in lead:
                return None
        for p in polys:
            if p.ndim == 2:
                continue
            if p.ndim != 1 or p.axes[0] not in lead:
                return None

        levels: list[tuple[str, list[int]]] = []
        dim1_lead = 0
        n_items = 1
        empty = False
        for name in lead:
            ax = g["axes"][name]
            sels = [s for s in selects if s.axis == name]
            pls = [p for p in polys if p.ndim == 1 and p.axes[0] == name]
            # One constraint per leading axis: several (or a select AND
            # a span) make the host enqueue overlapping frontier items
            # whose union/stat semantics we don't replicate.
            if len(sels) + len(pls) > 1:
                return None
            if isinstance(ax, CategoricalAxis):
                if pls:
                    return None
                if sels:
                    pos, seen = [], set()
                    for v in sels[0].values:
                        p_ = ax.find(v)
                        if p_ is not None and p_ not in seen:
                            seen.add(p_)
                            pos.append(int(p_))
                else:
                    pos = list(range(len(ax)))
            elif isinstance(ax, OrderedAxis):
                if sels:
                    pos = [int(ax.nearest(ax.to_float(v))[0])
                           for v in sels[0].values]
                    if len(set(pos)) != len(pos):
                        return None   # duplicate frontier items
                elif pls:
                    lo, hi = pls[0].extents(name)
                    parr, _ = ax.indices_in_range(lo, hi)
                    pos = [int(x) for x in parr]
                    dim1_lead += n_items * len(pos)
                else:
                    pos = list(range(len(ax)))
            else:
                return None
            if not pos:
                empty = True
                break
            levels.append((name, pos))
            n_items *= len(pos)
        if not empty and n_items * len(polys2) > self.max_jobs:
            return None
        return levels, polys2, dim1_lead, empty

    # -- planning ----------------------------------------------------------
    def plan(self, request: Request
             ) -> tuple[ExtractionPlan, SliceStats] | None:
        t_start = time.perf_counter()
        if self._grid is False:
            self._grid = self._prepare_grid()
        g = self._grid
        if g is None:
            return None
        resolved = self._resolve_leading(g, request)
        if resolved is None:
            return None
        levels, polys2, dim1_lead, empty = resolved
        dc = self.datacube
        itemsize = dc.dtype.itemsize

        if empty:
            return self._finish(np.empty(0, np.int64), 0, dim1_lead, 0.0,
                                t_start, itemsize)

        # Static row budget: the widest major-index range over the
        # polytopes (identical for every leading path), padded for lanes.
        max_rows = max(_row_count(g["sv0"], g["eps0"], p, g["major"])
                       for p in polys2)
        if max_rows == 0:
            return self._finish(np.empty(0, np.int64), 0, dim1_lead, 0.0,
                                t_start, itemsize)
        max_rows = -(-max_rows // 8) * 8

        # Pack jobs: (leading path × polytope).
        names = [n for n, _ in levels]
        paths = [dict(zip(names, combo))
                 for combo in itertools.product(*(p for _, p in levels))]
        vmax = max(p.n_vertices for p in polys2)
        j_n = len(paths) * len(polys2)
        verts = np.zeros((j_n, vmax, 2), self.dtype)
        valid = np.zeros((j_n, vmax), bool)
        bases = np.zeros(j_n, np.int64)
        j = 0
        for path in paths:
            b = dc.base_offset(path)
            for p in polys2:
                k0 = p.axes.index(g["major"])
                k1 = p.axes.index(g["minor"])
                nv = p.n_vertices
                verts[j, :nv, 0] = p.points[:, k0]
                verts[j, :nv, 1] = p.points[:, k1]
                valid[j, :nv] = True
                bases[j] = b
                j += 1

        scalars = np.array([g["eps0"], g["eps1"], PLANE_TOL, g["period"]],
                           self.dtype)
        t_pipe = time.perf_counter()
        starts, lens, meta = self._invoke(verts, valid, bases, scalars,
                                          g, max_rows)
        pipe_dt = time.perf_counter() - t_pipe

        n_runs, n_rows, n_pts = (int(meta[0]), int(meta[1]), int(meta[2]))
        run_starts = starts.astype(np.int64)          # the n_runs live runs
        run_lens = lens.astype(np.int64)
        # Expand runs → offsets, dedupe across jobs (union members /
        # cyclic seam overlap), re-coalesce into sorted burst runs — the
        # same canonical form `flatten` emits.
        ends = np.cumsum(run_lens)
        total = int(ends[-1]) if n_runs else 0
        offsets = (np.repeat(run_starts, run_lens)
                   + np.arange(total, dtype=np.int64)
                   - np.repeat(ends - run_lens, run_lens))
        offsets = np.unique(offsets)
        return self._finish(offsets, n_rows, dim1_lead + n_pts, pipe_dt,
                            t_start, itemsize)

    def _invoke(self, verts, valid, bases, scalars, g, max_rows):
        """Run the pipeline; returns the live run starts and lengths and
        meta, as numpy arrays."""
        from ..kernels.plan import ops as plan_ops

        starts, lens, meta = plan_ops.plan_runs_2d(
            *self.pipeline_inputs(verts, valid, bases, scalars, g),
            n0=g["n0"], n1=g["n1"], max_rows=max_rows, cyclic=g["cyclic"])
        # meta first, then only the live prefix of both buffers, in one
        # transfer: the slots past n_runs are zero and never read.
        meta = meta.cpu().numpy()
        n_runs = int(meta[0])
        live = torch.stack((starts[:n_runs], lens[:n_runs])).cpu().numpy()
        return live[0], live[1], meta

    def pipeline_inputs(self, verts, valid, bases, scalars, g
                        ) -> tuple[torch.Tensor, ...]:
        """The pipeline's tensors on this planner's device, in
        ``plan_runs_2d`` argument order (verts, valid, base, sv0,
        rowoff0, sv1, scalars)."""
        n_el = self.datacube.n_elements
        dev = self.device
        fdt = torch.float64 if self.dtype == np.float64 else torch.float32
        if self._tables is None:
            # The cube's axis tables go to the device once.
            self._tables = (
                torch.from_numpy(g["sv0"]).to(dev, fdt),
                torch.from_numpy(checked_cast_i32(
                    g["rowoff"], what="device planner row offsets",
                    n_elements=n_el)).to(dev),
                torch.from_numpy(g["sv1"]).to(dev, fdt))
        sv0, rowoff, sv1 = self._tables
        # Every run start is the offset of a real element (base + row
        # offset + column < n_elements < 2³¹), so the kernel's int32
        # outputs cannot wrap.
        base = torch.from_numpy(checked_cast_i32(
            bases, what="device planner base offsets",
            n_elements=n_el)).to(dev)
        return (torch.from_numpy(verts).to(dev),
                torch.from_numpy(valid).to(dev), base, sv0, rowoff, sv1,
                torch.from_numpy(scalars).to(dev))

    def _finish(self, offsets, n_rows, n_dim1, pipe_dt, t_start, itemsize):
        run_starts, run_lens = coalesce_runs(offsets)
        plan = ExtractionPlan(offsets=offsets, run_starts=run_starts,
                              run_lengths=run_lens, coords={},
                              itemsize=itemsize)
        stats = SliceStats()
        if n_rows:
            stats.record_slices(2, n_rows, 0.0)
        if n_dim1:
            stats.record_slices(1, n_dim1, 0.0)
        stats.n_points = len(offsets)
        stats.slicing_time_s = pipe_dt
        stats.total_time_s = time.perf_counter() - t_start
        return plan, stats
