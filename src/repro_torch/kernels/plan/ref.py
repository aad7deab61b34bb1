"""Plain PyTorch version of the device-resident planning pipeline.

Fuses the trailing-2-D stage of Algorithm 1 — the part that dominates
cold-path planning — into one computation, where the host planner
round-trips through Python per BFS layer:

  row discovery   per (job) polytope: extents on the major axis →
                  index range (comparison-count ``searchsorted``,
                  byte-identical to ``OrderedAxis.indices_in_range``);
  slice           every (job, row) pair at once, reduced to the minor-
                  coordinate extents (``kernels.slice
                  .slice_minor_extents`` — the shared slicing core);
  column ranges   minor-axis index ranges per row, with the cyclic
                  seam split (≤ 2 storage segments per row, mirroring
                  ``CyclicAxis.indices_in_range``);
  run emission    vector leaves become ``(run_start, run_length)``
                  pairs in storage offsets — the representation the
                  burst gather reads — compacted in slot order.

A *job* is one (leading-axis path × polytope) pair; ``base`` carries
the path's storage base offset, so the emitted runs are absolute.

Numerics: every comparison/interpolation mirrors the host planner's
formulas operation-for-operation (``OrderedAxis.indices_in_range`` eps
widening, ``geometry.slice_vertices`` pairwise lerp), so under float64
inputs the emitted byte set is bit-identical to the host plan.  Offsets
are int64 until the final range-checked cast to the int32 buffers.

Layout: runs are compacted in flat slot order ``(job, row, segment)``
with segment 0 = the in-window range and segment 1 = the wrapped
(pre-seam) range; the CUDA kernel (``kernel.plan_runs_2d``) produces the
same buffer byte for byte.
"""

from __future__ import annotations

import torch

from .._casting import checked_cast_i32, ensure_i32_addressable
from ..slice.ref import slice_minor_extents

# scalars[] layout shared with the CUDA kernel
EPS0, EPS1, PLANE_TOL_REL, PERIOD = range(4)


def _count_lt(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """# of ``values`` < x — ``searchsorted(side='left')`` as a
    comparison count."""
    return (values < x[..., None]).sum(-1, dtype=torch.int32)


def _count_le(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """# of ``values`` ≤ x — ``searchsorted(side='right')``."""
    return (values <= x[..., None]).sum(-1, dtype=torch.int32)


def row_slots_2d(verts, valid, base, sv0, rowoff0, sv1, scalars, *,
                 n0: int, n1: int, max_rows: int, cyclic: bool):
    """Uncompacted run slots for every (job, row): the device frontier.

    verts   — (J, V, 2) padded vertices, (major, minor) coordinates
    valid   — (J, V) bool vertex mask
    base    — (J,) int32 storage base offset of the job's leading path
    sv0     — (n0,) sorted major-axis values
    rowoff0 — (n0,) int32 storage offset of each sorted major index
    sv1     — (n1,) sorted minor-axis values (identity storage order,
              unit stride — the run-contiguity precondition)
    scalars — (4,) float: [eps0, eps1, plane_tol_rel, period]

    Returns (starts (J, R, 2) int64, lengths (J, R, 2) int32,
    ok (J, R, 2) bool, n_rows (), n_points ()): segment 0 is the
    in-window column range, segment 1 the wrapped pre-seam range
    (cyclic only).  ``n_rows`` counts candidate rows (the §5.2 dim-2
    slice count), ``n_points`` the emitted points pre-dedupe (dim-1).
    """
    ensure_i32_addressable(n0 * n1, what="plan_runs_2d trailing grid")
    R = max_rows
    dev = verts.device
    big = torch.tensor(float("inf"), dtype=verts.dtype, device=dev)
    eps0 = scalars[EPS0]
    eps1 = scalars[EPS1]
    period = scalars[PERIOD]

    x = verts[:, :, 0]                                   # (J, V)
    y = verts[:, :, 1]

    # -- row discovery (Alg.1 lines 6-7 on the major axis) ---------------
    lo0 = torch.where(valid, x, big).amin(1)             # (J,)
    hi0 = torch.where(valid, x, -big).amax(1)
    i0 = _count_lt(sv0, lo0 - eps0)                      # (J,)
    i1 = _count_le(sv0, hi0 + eps0)
    r = i0[:, None] + torch.arange(R, dtype=torch.int32, device=dev)
    row_ok = r < i1[:, None]                             # (J, R)
    rc = r.clamp(0, n0 - 1).long()
    rv = sv0[rc]                                         # (J, R) values
    row_off = base[:, None].long() + rowoff0[rc].long()  # (J, R) offsets

    # -- slice every (job, row) pair at once -----------------------------
    # Host parity: geometry.slice_vertices scales its on-plane tolerance
    # by max(1, |major coords|max) per polytope.
    amax = torch.where(valid, x.abs(), 0.0).amax(1)
    scale = torch.maximum(torch.ones_like(amax), amax)
    tol = scalars[PLANE_TOL_REL] * scale                 # (J,)
    lo1, hi1, hit = slice_minor_extents(
        x[:, None, :], y[:, None, :], valid[:, None, :], rv, tol[:, None])

    # -- column ranges on the minor axis (≤ 2 storage segments) ----------
    if cyclic:
        whole = (hi1 - lo1) >= period                    # whole circle
        m = torch.floor((lo1 - sv1[0]) / period)
        lo_s = lo1 - m * period
        hi_s = hi1 - m * period
        jA0 = torch.where(whole, 0, _count_lt(sv1, lo_s - eps1))
        jA1 = torch.where(whole, n1, _count_le(sv1, hi_s + eps1))
        jB1 = torch.where(whole, 0, _count_le(sv1, hi_s - period + eps1))
    else:
        jA0 = _count_lt(sv1, lo1 - eps1)
        jA1 = _count_le(sv1, hi1 + eps1)
        jB1 = torch.zeros_like(jA0)

    len_a = (jA1 - jA0).clamp(min=0)
    ok_a = row_ok & hit & (len_a > 0)
    len_b = jB1.clamp(min=0)
    ok_b = (row_ok & hit & (len_b > 0)) if cyclic \
        else torch.zeros_like(ok_a)

    starts = torch.stack([row_off + jA0, row_off], dim=-1)     # (J, R, 2)
    lengths = torch.stack([len_a, len_b], dim=-1)
    ok = torch.stack([ok_a, ok_b], dim=-1)
    n_rows = row_ok.sum(dtype=torch.int32)
    n_points = torch.where(ok, lengths, 0).sum(dtype=torch.int32)
    return starts, lengths, ok, n_rows, n_points


def plan_runs_2d(verts, valid, base, sv0, rowoff0, sv1, scalars, *,
                 n0: int, n1: int, max_rows: int, cyclic: bool):
    """The fused pipeline: frontier → compacted run buffer, one call.

    Returns (run_starts (M,) int32, run_lengths (M,) int32,
    meta (3,) int32 = [n_runs, n_rows, n_points]) with
    M = J · max_rows · 2; slots past ``n_runs`` are zero.  Compaction
    keeps the live slots in slot order: an exclusive prefix sum over
    the valid-run mask gives each its position.
    """
    starts, lengths, ok, n_rows, n_points = row_slots_2d(
        verts, valid, base, sv0, rowoff0, sv1, scalars,
        n0=n0, n1=n1, max_rows=max_rows, cyclic=cyclic)
    m = starts.numel()
    ok_f = ok.reshape(m)
    pos = torch.cumsum(ok_f, 0) - ok_f.long()            # exclusive scan
    n_runs = ok_f.sum(dtype=torch.int32)
    run_starts = torch.zeros(m, dtype=torch.int32, device=verts.device)
    run_lengths = torch.zeros(m, dtype=torch.int32, device=verts.device)
    run_starts[pos[ok_f]] = checked_cast_i32(
        starts.reshape(m)[ok_f], what="plan_runs_2d run starts")
    run_lengths[pos[ok_f]] = lengths.reshape(m)[ok_f]
    meta = torch.stack([n_runs, n_rows, n_points])
    return run_starts, run_lengths, meta
