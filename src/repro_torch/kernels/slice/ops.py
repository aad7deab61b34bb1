"""Public entry points for batched slicing, plus the host adapters that
pack a BFS layer into tensors and rebuild polytopes from the result.

The tensors' device decides the path: CUDA tensors launch the CUDA
kernels (``kernel``), CPU tensors take the plain PyTorch versions
(``ref``).  There is no fallback between them.  ``use_pallas`` and
``interpret`` keep the JAX package's signature for parity and are
ignored — on the port the device decides.
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve_device
from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from . import kernel, ref


def _route(t: torch.Tensor, on_card, on_host):
    """``on_card`` for a CUDA tensor, ``on_host`` for a CPU tensor."""
    if t.device.type == "cuda":
        return on_card
    if t.device.type == "cpu":
        return on_host
    raise ValueError(f"no slicing path for a tensor on {t.device}")


def slice_batch(verts, valid, planes, k: int, use_pallas: bool = False,
                interpret: bool = True):
    """Slice a packed BFS layer (``ref.slice_batch`` contract); kernel B5
    on the card, which takes float32 only."""
    return _route(verts, kernel.slice_batch, ref.slice_batch)(
        verts, valid, planes, k)


def slice_minor_extents(x, y, valid, planes, tol):
    """Extents of the kept coordinate when each of B polytopes is cut by
    R planes: x, y, valid (B, V); planes (B, R); tol (B,) → (lo, hi,
    hit), each (B, R).  Kernel B4 on the card."""
    return _route(x, kernel.slice_minor_extents,
                  ref.slice_minor_extents_rows)(x, y, valid, planes, tol)


def batched_plan_2d(verts, valid, axis0, axis1, n0: int, n1: int,
                    max_rows: int, max_cols: int, field=None):
    """The batched crop planner (``ref.batched_plan_2d`` contract):
    (offsets, n_points, values or None).  One launch of its kernel on the
    card, the field's read included."""
    return _route(verts, kernel.batched_plan_2d, ref.batched_plan_2d)(
        verts, valid, axis0, axis1, n0, n1, max_rows, max_cols, field)


def pack_polytopes(polys, v_max: int | None = None, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a BFS layer of host Polytopes into padded tensors on
    ``device`` (None = the card): (P, V, D) float32 vertices and a
    (P, V) bool mask.  Polytopes with more than ``v_max`` vertices keep
    their first ``v_max``."""
    if not polys:
        raise ValueError("empty layer")
    dev = resolve_device(device)
    d = polys[0].points.shape[1]
    v_max = v_max or max(p.n_vertices for p in polys)
    p = len(polys)
    verts = np.zeros((p, v_max, d), np.float32)
    valid = np.zeros((p, v_max), bool)
    for i, poly in enumerate(polys):
        n = min(poly.n_vertices, v_max)
        verts[i, :n] = poly.points[:n]
        valid[i, :n] = True
    return torch.from_numpy(verts).to(dev), torch.from_numpy(valid).to(dev)


def unpack_sliced(out, mask, axes, k: int):
    """Rebuild host Polytopes from the sliced layer (drops the sliced
    axis k); ``None`` where the plane missed the polytope."""
    from ...core.geometry import Polytope, _dedupe
    from ...core.hull import convex_hull_prune

    if isinstance(out, torch.Tensor):
        out, mask = out.cpu().numpy(), mask.cpu().numpy()
    out = np.asarray(out, np.float64)
    mask = np.asarray(mask)
    rest = tuple(a for j, a in enumerate(axes) if j != k)
    keep_cols = [j for j in range(out.shape[2]) if j != k]
    polys = []
    for i in range(out.shape[0]):
        pts = out[i][mask[i]][:, keep_cols]
        if len(pts) == 0:
            polys.append(None)
            continue
        pts = convex_hull_prune(_dedupe(pts))
        polys.append(Polytope(rest, pts))
    return polys
