"""On-device batched extraction for 2-D polytopes on regular grids.

The host slicer (Algorithm 1) plans one request at a time in float64.
Training pipelines want the opposite trade: *many congruent small
requests per step* (batched country crops, per-sample regions of
interest) with fixed shapes, planned on the card itself.

This module runs one BFS layer of Algorithm 1 as a batched device
computation: for a batch of convex 2-D polytopes over regular ordered
axes,

  1. per-polytope extents on axis 0 → index ranges (``searchsorted``),
  2. slice every (polytope × row) pair at once — B4's cut,
     ``slice_minor_extents``,
  3. per-row 1-D extents on axis 1 → index ranges,
  4. emit a padded (P, R, C) offset lattice + validity mask — the
     batched extraction plan — and, for ``batched_extract_2d``, the
     field's values at it.

On the card all four steps, and the read, are one launch of the batched
crop planner (``kernels.slice``, ``csrc/batched_plan.cu``) after one
pinned copy of whatever numpy inputs the call was given; nothing is
read back to the host.  On the CPU they are its plain PyTorch version.

Shapes are fixed: R = max rows, C = max columns per row; masked slots
are -1 (the padding convention of the gather kernels).  Geometry is
float32 with the JAX package's ``1e-6`` tolerance regime.

``device=None`` means the card (raises when there is none); inputs may
be numpy arrays or tensors and are placed on ``device``.
``device="cpu"`` runs the plain PyTorch versions of the kernels.

One deliberate difference from the JAX package (ROADMAP C7):
``batched_extract_2d`` refuses a field of fewer than n0·n1 elements
before any work, where the JAX function checks nothing (its ``jnp.take``
reads a fill value for an offset past the field).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, upload
from ..kernels._casting import ensure_i32_addressable
from ..kernels.slice import ops as slice_ops
from ..kernels.slice import ref as slice_ref


def _on(device, *arrays) -> list[torch.Tensor]:
    """``arrays`` as contiguous tensors on ``device``: the numpy arrays
    in one packed (pinned, for the card) copy, tensors moved only when
    they lie elsewhere."""
    dev = resolve_device(device)
    host = upload(dev, *(a for a in arrays if isinstance(a, np.ndarray)))
    host.reverse()
    return [(host.pop() if isinstance(a, np.ndarray)
             else torch.as_tensor(a, device=dev)).contiguous()
            for a in arrays]


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
    offsets, n_points, _ = slice_ops.batched_plan_2d(
        *_on(device, verts, valid, axis0, axis1), n0, n1, max_rows,
        max_cols)
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
    slots, plus the offset lattice and the point counts.  On the card the
    plan and the read are one launch.  ``flat_data`` is the (n0·n1,)
    field, row-major over (axis0, axis1); a shorter one raises
    ``IndexError`` before any work (ROADMAP C7)."""
    n0, n1 = int(len(axis0)), int(len(axis1))
    ensure_i32_addressable(n0 * n1, what="batched_plan_2d grid")
    if len(flat_data) < n0 * n1:
        raise IndexError(f"batched_extract_2d: a field of {len(flat_data)} "
                         f"elements for a grid of {n0} x {n1} = {n0 * n1}")
    flat, *tens = _on(device, flat_data, verts, valid, axis0, axis1)
    offsets, n_points, values = slice_ops.batched_plan_2d(
        *tens, n0, n1, max_rows, max_cols, field=flat)
    return values, offsets, n_points
