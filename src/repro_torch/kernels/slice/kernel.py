"""CUDA kernels for batched slicing: B5 ``slice_batch``
(``csrc/slice_batch.cu``), the batched crop planner ``batched_plan_2d``
with B4's cut inside it (``csrc/batched_plan.cu``), and B4
``slice_minor_extents`` launched on its own (``csrc/slice_extents.cu``).

Each wrapper checks its tensors, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch is refused, and counts the launch in ``LAUNCHES``.  Each is held
byte for byte against ``ref``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES
from .ref import promote_bool


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

    No path of the package launches this wrapper: its device function
    runs inside ``batched_plan_2d``'s and B3's launches.  It stays as the
    counterpart of the JAX ``slice_minor_extents``, held and timed on its
    own.
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


# Element widths the batched planner's read moves as opaque words (B1's).
WORD_BYTES = (1, 2, 4, 8)

def batched_plan_2d(verts: torch.Tensor, valid: torch.Tensor,
                    axis0: torch.Tensor, axis1: torch.Tensor, n0: int,
                    n1: int, max_rows: int, max_cols: int,
                    field: torch.Tensor | None = None):
    """The batched crop planner in one launch: ``ref.batched_plan_2d``.

    verts — (P, V, 2) float32 or float64 CUDA tensor; axis0 (len0,) and
            axis1 (len1,) sorted, of the same dtype; valid (P, V) bool
    n0, n1 — the grid, 0 <= n0 <= len0 and 0 <= n1 <= len1, with
            n0·n1 <= 2^31 (checked by the caller:
            ``ensure_i32_addressable``)
    field — None, or a 1-D CUDA tensor of at least n0·n1 elements of any
            dtype of width 1, 2, 4 or 8, read at the plan in the same
            launch
    Returns (offsets (P, max_rows, max_cols) int32, n_points (P,) int32,
    values (P, max_rows·max_cols) or None).  Nothing is read back.
    """
    dev = _build.cuda_device(verts, "batched_plan_2d verts")
    fdt = verts.dtype
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"batched_plan_2d: coordinates must be float32 or "
                        f"float64, got {fdt}")
    _build.expect(verts, "batched_plan_2d verts", device=dev, dtype=fdt,
                  shape=(None, None, 2))
    p, v, _ = verts.shape
    _build.expect(valid, "batched_plan_2d valid", device=dev,
                  dtype=torch.bool, shape=(p, v))
    _build.expect(axis0, "batched_plan_2d axis0", device=dev, dtype=fdt,
                  shape=(None,))
    _build.expect(axis1, "batched_plan_2d axis1", device=dev, dtype=fdt,
                  shape=(None,))
    len0, len1 = axis0.shape[0], axis1.shape[0]
    if not (0 <= n0 <= len0 and 0 <= n1 <= len1):
        raise ValueError(f"batched_plan_2d: grid {n0} x {n1} outside the "
                         f"axes' {len0} x {len1} values")
    if max_rows < 0 or max_cols < 0:
        raise ValueError(f"batched_plan_2d: max_rows={max_rows}, "
                         f"max_cols={max_cols}")
    offsets = torch.empty((p, max_rows, max_cols), dtype=torch.int32,
                          device=dev)
    n_points = torch.empty((p,), dtype=torch.int32, device=dev)
    values = None
    if field is not None:
        _build.expect(field, "batched_plan_2d field", device=dev,
                      dtype=field.dtype, shape=(None,))
        if field.element_size() not in WORD_BYTES:
            raise TypeError(f"batched_plan_2d: field elements of "
                            f"{field.element_size()} bytes")
        if field.shape[0] < n0 * n1:
            raise IndexError(f"batched_plan_2d: a field of "
                             f"{field.shape[0]} elements for a grid of "
                             f"{n0} x {n1}")
        values = torch.empty((p, max_rows * max_cols), dtype=field.dtype,
                             device=dev)
    if p == 0:
        return offsets, n_points, _promoted(values)
    lib = _build.library("batched_plan")
    status = lib.polytope_batched_plan_2d(
        dev.index or 0, int(fdt == torch.float64), verts.data_ptr(),
        valid.data_ptr(), v, axis0.data_ptr(), len0, n0, axis1.data_ptr(),
        len1, n1, p, max_rows, max_cols,
        None if field is None else field.data_ptr(),
        0 if field is None else field.element_size(), offsets.data_ptr(),
        n_points.data_ptr(), None if values is None else values.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, "batched_plan_2d")
    LAUNCHES["batched_plan_2d"] += 1
    return offsets, n_points, _promoted(values)


def _promoted(values: torch.Tensor | None) -> torch.Tensor | None:
    """A bool field's values, read as 1-byte words, cast to int32 as the
    plain version (``ref.promote_bool``) and the JAX package give them."""
    return None if values is None else promote_bool(values)
