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
planning kernel inlines it (``csrc/slice_extents.cuh``) and
``core/batched.py`` launches it on its own (``csrc/slice_extents.cu``).
Every operation is rounded on its own, as the kernels round it (no
``lerp``/``addcmul``, whose rounding differs).
"""

from __future__ import annotations

import torch

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
