"""Plain PyTorch versions of batched polytope-hyperplane slicing.

``slice_batch`` (kernel B5, ``csrc/slice_batch.cu``) slices one BFS
layer of Algorithm 1 as a batch: every (polytope, plane) pair at once
(DESIGN.md §3, "BFS layer = batch").

Layout (fixed shapes):
  verts  — (P, V, D) float32, padded vertices
  valid  — (P, V)    bool, vertex validity
  planes — (P,)      float32, slice plane position per polytope
  k      — int, the axis being sliced

Output: (P, V + V*V, D) candidate vertices + (P, V + V*V) validity.
Slot layout: the first V slots are "vertex on plane" hits; slot
V + i*V + j is the interpolation between vertex i (below) and vertex j
(above).  Invalid slots hold +0.0.  The sliced axis k keeps its
coordinate (== plane) so D stays fixed; callers drop it when rebuilding
Polytope objects (``ops.unpack_sliced``).

``slice_minor_extents`` (kernel B4) is the same sign split and
all-pairs lerp reduced to the extents of the kept coordinate; the
planning kernel (``csrc/plan_runs_2d.cu``) and the batched crop planner
(``csrc/batched_plan.cu``) inline it from ``csrc/slice_extents.cuh``,
and ``csrc/slice_extents.cu`` launches it on its own.
``batched_plan_2d`` is the batched crop planner of ``core/batched.py``
with B4's cut in it, and its read when a field is passed.
Every operation is rounded on its own, as the kernels round it (no
``lerp``/``addcmul``, whose rounding differs).
"""

from __future__ import annotations

import torch

from .._casting import checked_cast_i32
from ..gather import ref as gather_ref

PLANE_TOL = 1e-6


def slice_minor_extents(x: torch.Tensor, y: torch.Tensor,
                        valid: torch.Tensor, planes: torch.Tensor,
                        tol_scaled) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Extents of the remaining coordinate after slicing, batched.

    The planning pipeline (``repro_torch.kernels.plan``) never needs the
    sliced vertex *set* — only the min/max of the remaining coordinate
    (Algorithm 1 line 6 of the next layer).

    x, y       — (..., V) sliced-axis / kept-axis vertex coordinates
    valid      — (..., V) vertex mask
    planes     — (...,)   slice plane per batch element
    tol_scaled — broadcastable to (...,): absolute on-plane tolerance
                 (host parity wants ``geometry.PLANE_TOL * max(1,
                 |x|max)``)

    Returns (lo, hi, hit) of shape (...,): the kept-coordinate extents
    of the intersection and whether the plane hits at all.  ``lo``/``hi``
    are ±inf where ``hit`` is False.  Exactly mirrors the host
    ``geometry.slice_vertices`` candidate set: on-plane vertices keep
    their y; every (below, above) pair contributes
    ``y_i + t·(y_j − y_i)`` with ``t = d_i / (d_i − d_j)``, each
    operation rounded on its own (no ``lerp``/``addcmul``, whose
    rounding differs) — min/max are unchanged by the host's hull prune
    and dedupe, so in float64 the extents match the host planner
    bit-for-bit.
    """
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    tol = torch.as_tensor(tol_scaled, dtype=x.dtype,
                          device=x.device)[..., None]
    d = torch.where(valid, x - planes[..., None], big)       # (..., V)

    on = valid & (d.abs() <= tol)
    below = valid & (d < -tol)
    above = valid & (d > tol) & torch.isfinite(d)

    y_on_lo = torch.where(on, y, big)
    y_on_hi = torch.where(on, y, -big)

    di = torch.where(below, d, 0.0)[..., :, None]            # (..., V, 1)
    dj = torch.where(above, d, 0.0)[..., None, :]            # (..., 1, V)
    denom = di - dj
    t = di / torch.where(denom == 0, 1.0, denom)             # (..., V, V)
    yi = y[..., :, None]
    yj = y[..., None, :]
    yp = yi + t * (yj - yi)
    pair = below[..., :, None] & above[..., None, :]
    y_pair_lo = torch.where(pair, yp, big)
    y_pair_hi = torch.where(pair, yp, -big)

    lo = torch.minimum(y_on_lo.amin(-1), y_pair_lo.amin((-2, -1)))
    hi = torch.maximum(y_on_hi.amax(-1), y_pair_hi.amax((-2, -1)))
    hit = on.any(-1) | (below.any(-1) & above.any(-1))
    return lo, hi, hit


def slice_minor_extents_rows(x: torch.Tensor, y: torch.Tensor,
                             valid: torch.Tensor, planes: torch.Tensor,
                             tol: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``slice_minor_extents`` with kernel B4's layout: x, y, valid
    (B, V); planes (B, R); tol (B,) → (lo, hi, hit), each (B, R)."""
    return slice_minor_extents(x[:, None, :], y[:, None, :],
                               valid[:, None, :], planes, tol[:, None])


def slice_batch(verts: torch.Tensor, valid: torch.Tensor,
                planes: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    p, v, d = verts.shape
    c = planes[:, None]                                  # (P, 1)
    coord = verts[:, :, k]                               # (P, V)
    scale = torch.clamp(coord.abs().amax(1, keepdim=True), min=1.0)
    inf = torch.tensor(float("inf"), dtype=verts.dtype, device=verts.device)
    dist = torch.where(valid, coord - c, inf)            # (P, V)
    tol = PLANE_TOL * scale

    on = (dist.abs() <= tol) & valid
    below = (dist < -tol) & valid
    above = (dist > tol) & torch.isfinite(dist) & valid

    # on-plane vertices, coordinate k snapped onto the plane
    on_pts = verts.clone()
    on_pts[:, :, k] = c.expand(p, v)

    # all-pairs interpolation i(below) -> j(above)
    di = torch.where(below, dist, 0.0)[:, :, None]           # (P, V, 1)
    dj = torch.where(above, dist, 0.0)[:, None, :]           # (P, 1, V)
    denom = di - dj
    t = torch.where(denom.abs() > 0,
                    di / torch.where(denom == 0, 1.0, denom), 0.0)
    vi = verts[:, :, None, :]                                # (P, V, 1, D)
    vj = verts[:, None, :, :]                                # (P, 1, V, D)
    interp = vi + t[..., None] * (vj - vi)                   # (P, V, V, D)
    interp[:, :, :, k] = c[:, :, None].expand(p, v, v)
    pair_valid = below[:, :, None] & above[:, None, :]       # (P, V, V)

    out = torch.cat([on_pts, interp.reshape(p, v * v, d)], dim=1)
    out_valid = torch.cat([on, pair_valid.reshape(p, v * v)], dim=1)
    out = torch.where(out_valid[..., None], out, 0.0)
    return out, out_valid


def batched_plan_2d(verts: torch.Tensor, valid: torch.Tensor,
                    axis0: torch.Tensor, axis1: torch.Tensor, n0: int,
                    n1: int, max_rows: int, max_cols: int,
                    field: torch.Tensor | None = None):
    """Plan a batch of convex 2-D polytopes on a regular (n0 × n1) grid
    (``core.batched.batched_plan_2d``), and read ``field`` at the plan
    when one is given.

    verts (P, V, 2), valid (P, V), axis0 (n0,) and axis1 (n1,) sorted.
    Returns (offsets (P, max_rows, max_cols) int32 with -1 padding,
    n_points (P,) int32, values (P, max_rows·max_cols) of the field's
    dtype with 0 at padded slots, or None without a field).
    """
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
    lo1, hi1, hit2 = slice_minor_extents_rows(
        verts[:, :, 0].contiguous(), verts[:, :, 1].contiguous(), valid,
        row_vals.contiguous(), PLANE_TOL * scale)
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
    if field is None:
        return offsets, n_points, None
    flat_off = offsets.reshape(p, -1)
    taken = gather_ref.gather_rows(field[:, None],
                                   flat_off.clamp(min=0).reshape(-1))
    values = torch.where(flat_off >= 0, taken.reshape(flat_off.shape),
                         torch.zeros((), dtype=field.dtype,
                                     device=field.device))
    return offsets, n_points, promote_bool(values)


def promote_bool(values: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``jnp.where(mask, take, 0)`` promotes a bool
    field's values to int32; every other dtype keeps its own."""
    # Bool values promoted, not offsets: 0 and 1 fit any width.
    return values.to(torch.int32) if values.dtype == torch.bool else values  # lint-ok: unchecked-i32-cast
