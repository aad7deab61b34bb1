"""CUDA kernel B3: the planning pipeline on the card
(``csrc/plan_runs_2d.cu``).

One call runs the whole Algorithm-1 trailing stage for every job — row
discovery, slicing, column ranges, run emission, compaction — and
returns the compacted ``(run_start, run_length)`` buffer the burst
gather reads.  The TPU kernel appended at a cursor carried across its
sequential grid; here three launches (slots, scan, scatter) replace the
cursor, and the buffer is byte-identical to ``ref.plan_runs_2d``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES
from .._casting import ensure_i32_addressable


def plan_runs_2d(verts, valid, base, sv0, rowoff0, sv1, scalars, *,
                 n0: int, n1: int, max_rows: int, cyclic: bool):
    """Device pipeline with the ``ref.plan_runs_2d`` contract: returns
    (run_starts (M,) int32, run_lengths (M,) int32, meta (3,) int32)
    with M = J · max_rows · 2.  All inputs are contiguous CUDA tensors on
    one device; the float inputs share one dtype, float64 or float32."""
    dev = _build.cuda_device(verts, "plan_runs_2d verts")
    fdt = verts.dtype
    if fdt not in (torch.float64, torch.float32):
        raise TypeError(f"plan_runs_2d: vertices must be float64 or "
                        f"float32, got {fdt}")
    _build.expect(verts, "plan_runs_2d verts", device=dev, dtype=fdt,
                  shape=(None, None, 2))
    j, v = verts.shape[0], verts.shape[1]
    _build.expect(valid, "plan_runs_2d valid", device=dev,
                  dtype=torch.bool, shape=(j, v))
    _build.expect(base, "plan_runs_2d base", device=dev, dtype=torch.int32,
                  shape=(j,))
    _build.expect(sv0, "plan_runs_2d sv0", device=dev, dtype=fdt,
                  shape=(n0,))
    _build.expect(rowoff0, "plan_runs_2d rowoff0", device=dev,
                  dtype=torch.int32, shape=(n0,))
    _build.expect(sv1, "plan_runs_2d sv1", device=dev, dtype=fdt,
                  shape=(n1,))
    _build.expect(scalars, "plan_runs_2d scalars", device=dev, dtype=fdt,
                  shape=(4,))
    ensure_i32_addressable(n0 * n1, what="plan_runs_2d trailing grid")
    m = j * max_rows * 2
    if m == 0:
        zero = torch.zeros((m,), dtype=torch.int32, device=dev)
        return zero, zero.clone(), torch.zeros(3, dtype=torch.int32,
                                               device=dev)
    if m >= 2 ** 31:
        raise OverflowError(f"plan_runs_2d: {m} slots exceed the int32 "
                            f"positions of the compaction scan")
    run_starts = torch.empty(m, dtype=torch.int32, device=dev)
    run_lengths = torch.empty(m, dtype=torch.int32, device=dev)
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * m, dtype=torch.int32, device=dev)
    lib = _build.library("plan_runs_2d")
    status = lib.polytope_plan_runs_2d(
        dev.index or 0, int(fdt == torch.float64), verts.data_ptr(),
        valid.data_ptr(), base.data_ptr(), sv0.data_ptr(),
        rowoff0.data_ptr(), sv1.data_ptr(), scalars.data_ptr(), j, v, n0,
        n1, max_rows, int(cyclic), scratch.data_ptr(), run_starts.data_ptr(),
        run_lengths.data_ptr(), meta.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, "plan_runs_2d")
    LAUNCHES["plan_runs_2d"] += 1
    return run_starts, run_lengths, meta
