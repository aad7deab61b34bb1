"""CUDA kernels for batched slicing: B5 ``slice_batch``
(``csrc/slice_batch.cu``) and B4 ``slice_minor_extents`` launched on its
own (``csrc/slice_extents.cu``).

Each wrapper checks its tensors, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch is refused, and counts the launch in ``LAUNCHES``.  Both are held
byte for byte against ``ref``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES


def slice_batch(verts: torch.Tensor, valid: torch.Tensor,
                planes: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice every polytope of a BFS layer by its own plane on axis k.

    verts  — (P, V, D) float32 CUDA tensor
    valid  — (P, V) bool
    planes — (P,) float32
    Returns (P, V + V*V, D) float32 candidates and a (P, V + V*V) bool
    mask, with the ``ref.slice_batch`` slot layout.
    """
    dev = _build.cuda_device(verts, "slice_batch verts")
    _build.expect(verts, "slice_batch verts", device=dev,
                  dtype=torch.float32, shape=(None, None, None))
    p, v, d = verts.shape
    _build.expect(valid, "slice_batch valid", device=dev, dtype=torch.bool,
                  shape=(p, v))
    _build.expect(planes, "slice_batch planes", device=dev,
                  dtype=torch.float32, shape=(p,))
    if not 0 <= k < d:
        raise ValueError(f"slice_batch: axis k={k} outside D={d}")
    slots = v + v * v
    out = torch.empty((p, slots, d), dtype=torch.float32, device=dev)
    mask = torch.empty((p, slots), dtype=torch.bool, device=dev)
    if p == 0 or v == 0:
        return out, mask
    lib = _build.library("slice_batch")
    status = lib.polytope_slice_batch(
        dev.index or 0, verts.data_ptr(), valid.data_ptr(),
        planes.data_ptr(), p, v, d, k, out.data_ptr(), mask.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, "slice_batch")
    LAUNCHES["slice_batch"] += 1
    return out, mask


def slice_minor_extents(x: torch.Tensor, y: torch.Tensor,
                        valid: torch.Tensor, planes: torch.Tensor,
                        tol: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cut each of B polytopes by R planes; extents of the kept axis.

    x, y   — (B, V) sliced-axis / kept-axis coordinates, float32 or
             float64 CUDA tensors of one dtype
    valid  — (B, V) bool vertex mask
    planes — (B, R) plane positions
    tol    — (B,) absolute on-plane tolerance per polytope
    Returns (lo, hi, hit), each (B, R): ``ref.slice_minor_extents`` on
    the broadcast shapes x[:, None, :], planes, tol[:, None].
    """
    dev = _build.cuda_device(x, "slice_minor_extents x")
    fdt = x.dtype
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"slice_minor_extents: coordinates must be float32 "
                        f"or float64, got {fdt}")
    _build.expect(x, "slice_minor_extents x", device=dev, dtype=fdt,
                  shape=(None, None))
    b, v = x.shape
    _build.expect(y, "slice_minor_extents y", device=dev, dtype=fdt,
                  shape=(b, v))
    _build.expect(valid, "slice_minor_extents valid", device=dev,
                  dtype=torch.bool, shape=(b, v))
    _build.expect(planes, "slice_minor_extents planes", device=dev,
                  dtype=fdt, shape=(b, None))
    _build.expect(tol, "slice_minor_extents tol", device=dev, dtype=fdt,
                  shape=(b,))
    r = planes.shape[1]
    lo = torch.empty((b, r), dtype=fdt, device=dev)
    hi = torch.empty((b, r), dtype=fdt, device=dev)
    hit = torch.empty((b, r), dtype=torch.bool, device=dev)
    if b * r == 0:
        return lo, hi, hit
    lib = _build.library("slice_extents")
    status = lib.polytope_slice_minor_extents(
        dev.index or 0, int(fdt == torch.float64), x.data_ptr(),
        y.data_ptr(), valid.data_ptr(), planes.data_ptr(), tol.data_ptr(),
        b, v, r, lo.data_ptr(), hi.data_ptr(), hit.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, "slice_minor_extents")
    LAUNCHES["slice_minor_extents"] += 1
    return lo, hi, hit
