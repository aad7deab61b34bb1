"""On-device batched extraction for 2-D polytopes on regular grids.

The host slicer (Algorithm 1) plans one request at a time in float64.
Training pipelines want the opposite trade: *many congruent small
requests per step* (batched country crops, per-sample regions of
interest) with fixed shapes, planned on the card itself.

This module runs one BFS layer of Algorithm 1 as a batched device
computation: for a batch of convex 2-D polytopes over regular ordered
axes,

  1. per-polytope extents on axis 0 → index ranges (``searchsorted``),
  2. slice every (polytope × row) pair at once — kernel B4
     ``slice_minor_extents`` on the card (``kernels.slice``),
  3. per-row 1-D extents on axis 1 → index ranges,
  4. emit a padded (P, R, C) offset lattice + validity mask — the
     batched extraction plan consumed by ``gather_rows`` (kernel B1).

Shapes are fixed: R = max rows, C = max columns per row; masked slots
are -1 (the padding convention of the gather kernels).  Geometry is
float32 with the JAX package's ``1e-6`` tolerance regime.

``device=None`` means the card (raises when there is none); inputs may
be numpy arrays or tensors and are placed on ``device``.
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..kernels._casting import checked_cast_i32, ensure_i32_addressable
from ..kernels.slice import ops as slice_ops
from ..kernels.slice import ref as slice_ref


def _on(device, *arrays) -> list[torch.Tensor]:
    dev = resolve_device(device)
    return [torch.as_tensor(a, device=dev) for a in arrays]


def batched_plan_2d(verts, valid, axis0, axis1, n0: int, n1: int,
                    max_rows: int, max_cols: int, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan a batch of convex 2-D polytopes on a regular (n0 × n1) grid.

    verts  — (P, V, 2) float32 polytope vertices (axis0, axis1 coords)
    valid  — (P, V) bool vertex mask
    axis0  — (n0,) sorted axis-0 index values
    axis1  — (n1,) sorted axis-1 index values

    Returns (offsets (P, max_rows, max_cols) int32 flat offsets with -1
    padding, n_points (P,)).
    """
    # A grid whose flat offsets overflow int32 fails loudly before any
    # work instead of truncating.
    ensure_i32_addressable(n0 * n1, what="batched_plan_2d grid")
    verts, valid, axis0, axis1 = _on(device, verts, valid, axis0, axis1)
    p, v, _ = verts.shape
    dev = verts.device
    big = torch.tensor(float("inf"), dtype=verts.dtype, device=dev)

    c0 = torch.where(valid, verts[:, :, 0], big)
    lo0 = c0.amin(1)
    hi0 = torch.where(valid, verts[:, :, 0], -big).amax(1)

    # rows intersecting each polytope
    start = torch.searchsorted(axis0, lo0 - 1e-6, side="left")  # (P,)
    row_ids = start[:, None] + torch.arange(max_rows, device=dev)[None, :]
    row_vals = axis0[row_ids.clamp(0, n0 - 1)]                  # (P, R)
    row_ok = (row_ids < n0) & (row_vals <= hi0[:, None] + 1e-6)

    # slice every (polytope, row) pair via the shared slicing core —
    # extents of the remaining coordinate only, so the (V × V) candidate
    # lattice never materializes.
    scale = torch.clamp(verts[:, :, 0].abs().amax(1), min=1.0)
    lo1, hi1, hit2 = slice_ops.slice_minor_extents(
        verts[:, :, 0].contiguous(), verts[:, :, 1].contiguous(), valid,
        row_vals.contiguous(), slice_ref.PLANE_TOL * scale)
    lo1 = lo1.reshape(p * max_rows)
    hi1 = hi1.reshape(p * max_rows)
    hit = hit2.reshape(p * max_rows) & row_ok.reshape(-1)

    c_start = torch.searchsorted(axis1, lo1 - 1e-6, side="left")
    col_ids = c_start[:, None] + torch.arange(max_cols, device=dev)[None, :]
    col_ok = (col_ids < n1) & \
        (axis1[col_ids.clamp(0, n1 - 1)] <= hi1[:, None] + 1e-6) & \
        hit[:, None]

    offsets = checked_cast_i32(torch.where(
        col_ok,
        row_ids.reshape(-1)[:, None] * n1 + col_ids.clamp(0, n1 - 1),
        -1), what="batched_plan_2d offsets", allow_negative_one=True)
    offsets = offsets.reshape(p, max_rows, max_cols)
    n_points = (offsets >= 0).sum((1, 2), dtype=torch.int32)
    return offsets, n_points


def batched_plan_runs_2d(verts, valid, axis0, axis1, max_rows: int,
                         use_pallas: bool = False, interpret: bool = True,
                         device=None):
    """Run-pair form of :func:`batched_plan_2d`: the compressed plan
    representation, straight from the planning kernel (B3, float32,
    ``cyclic=False``).

    Same geometry/tolerance conventions as the offset-lattice path (the
    f32 ``1e-6`` regime), but emits compacted ``(run_start, run_length)``
    pairs instead of the padded (P, R, C) lattice — rows become single
    entries regardless of width, and the output feeds
    ``kernels.gather.gather_plan_runs`` directly.  Returns
    (run_starts (M,) int32, run_lengths (M,) int32, meta (3,) int32 =
    [n_runs, n_rows, n_points]) flat across the batch in
    (polytope, row) order.  ``use_pallas`` and ``interpret`` keep the
    JAX package's signature and are ignored.
    """
    from ..kernels.plan import ops as plan_ops

    verts, valid, axis0, axis1 = _on(device, verts, valid, axis0, axis1)
    dev = verts.device
    p = verts.shape[0]
    n0, n1 = int(axis0.shape[0]), int(axis1.shape[0])
    ensure_i32_addressable(n0 * n1, what="batched_plan_runs_2d grid")
    # scalars layout: [eps0, eps1, plane_tol_rel, period]
    scalars = torch.tensor([1e-6, 1e-6, slice_ref.PLANE_TOL, 0.0],
                           dtype=verts.dtype, device=dev)
    rowoff = torch.arange(0, n0 * n1, n1, dtype=torch.int32, device=dev)
    return plan_ops.plan_runs_2d(
        verts, valid, torch.zeros(p, dtype=torch.int32, device=dev), axis0,
        rowoff, axis1, scalars, n0=n0, n1=n1, max_rows=max_rows,
        cyclic=False)


def batched_extract_2d(flat_data, verts, valid, axis0, axis1,
                       max_rows: int, max_cols: int, device=None):
    """Plan + gather: (P, max_rows·max_cols) values with 0 at padded
    slots, plus the offset lattice and the point counts.  The read is
    kernel B1 (``gather_rows``) on the card."""
    from ..kernels.gather import ops as gather_ops

    flat_data, = _on(device, flat_data)
    n0, n1 = int(len(axis0)), int(len(axis1))
    offsets, n_points = batched_plan_2d(verts, valid, axis0, axis1,
                                        n0, n1, max_rows, max_cols,
                                        device=flat_data.device)
    flat_off = offsets.reshape(offsets.shape[0], -1)
    taken = gather_ops.gather_rows(flat_data[:, None],
                                   flat_off.clamp(min=0).reshape(-1))
    vals = torch.where(flat_off >= 0, taken.reshape(flat_off.shape),
                       torch.zeros((), dtype=flat_data.dtype,
                                   device=flat_data.device))
    return vals, offsets, n_points
