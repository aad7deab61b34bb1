"""Plain PyTorch version of the shared slicing core.

``slice_minor_extents`` is the body the planning kernel inlines (its
CUDA form is the device function in ``csrc/slice_extents.cuh``).  The
batched ``slice_batch`` of the JAX package is not ported yet.
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
