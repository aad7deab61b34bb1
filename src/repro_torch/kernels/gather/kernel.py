"""CUDA kernels for exact-byte extraction gathers (``csrc/gather.cu``).

The planner has already computed *which* elements are needed; these
kernels read exactly those elements of the payload on the card, never
the rest of the datacube — the bounding-box baseline would stream the
whole enclosing block.

* ``gather_rows`` (B1) — (N, D) table × (M,) int32 indices → (M, D), a
  row moved in the widest packs its bytes and addresses allow, by a
  group of lanes chosen on the host (``rows_layout``).
* ``gather_plan_runs`` (B2) — a plan's coalesced runs copied straight
  into its N points, in one launch: no chunk lattice, no second gather.
* ``gather_union_slices`` — a serving window's union read and every
  plan's slice of it in one launch: ``out[j] = flat[union[positions[j]]]``.
* ``gather_rows_bag`` (B6) — EmbeddingBag(sum): (N, D) float32/float64
  table × (B, L) int32 bags padded with -1 → (B, D); two kernels, one
  for narrow rows and one for wide, chosen by the row's width.

Each wrapper checks its tensors, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch is refused, and counts the launch in ``LAUNCHES``.  The indices
arrive already validated and cast by ``ops`` (``checked_cast_i32``), and
for B2 and the union slices already on the card from one packed upload.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES


# Rows a group of B1 takes at once, by the group's lanes (measured on an
# H100 at a row width of each group: the note at the top of
# csrc/gather.cu), halved while a call would give fewer than MIN_WARPS
# warps (16 an SM): a small call is bound by its chains of dependent
# loads, not by the loads in flight.
ROWS_PER_GROUP = {1: 2, 2: 8, 4: 4, 8: 2, 16: 4, 32: 4}
MIN_WARPS = 132 * 16


def group_for(packs: int) -> int:
    """The smallest power of two, up to 32, that covers ``packs`` packs
    (``csrc/rows.cuh``'s ``group_for``)."""
    group = 1
    while group < 32 and group < packs:
        group <<= 1
    return group


def rows_layout(d: int, elem_bytes: int, m: int, table_ptr: int,
                out_ptr: int) -> tuple[int, int, int]:
    """B1's layout for ``m`` rows of ``d`` elements of ``elem_bytes`` bytes
    at the table and output addresses given: ``(vec_bytes, group,
    rows_per_group)``.  A row moves in packs of ``vec_bytes``, the largest
    power of two up to 16 that divides the row's bytes and both
    addresses; ``group`` lanes take a row (``group_for`` of its packs),
    ``rows_per_group`` rows at once.  ``polytope_gather_rows`` refuses
    another pack or group, and rows a group other than 1, 2, 4 or 8."""
    row_bytes = d * elem_bytes
    vec = 16
    while vec > 1 and (row_bytes % vec or table_ptr % vec or out_ptr % vec):
        vec >>= 1
    group = group_for(row_bytes // vec)
    rows = ROWS_PER_GROUP[group]
    while rows > 1 and -(-m * group // (32 * rows)) < MIN_WARPS:
        rows //= 2
    return vec, group, rows


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` on the card, in ``rows_layout``'s layout (the
    kernel refuses any other, and this raises).

    table   — (N, D) CUDA tensor of any dtype of width 1, 2, 4 or 8 bytes
    indices — (M,) int32 CUDA tensor, each in [0, N)
    """
    dev = _build.cuda_device(table, "gather_rows table")
    _build.expect(table, "gather_rows table", device=dev,
                  dtype=table.dtype, shape=(None, None))
    _build.expect(indices, "gather_rows indices", device=dev,
                  dtype=torch.int32, shape=(None,))
    m, d = indices.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=dev)
    if m == 0 or d == 0:
        return out
    layout = rows_layout(d, table.element_size(), m, table.data_ptr(),
                         out.data_ptr())
    lib = _build.library("gather")
    status = lib.polytope_gather_rows(
        dev.index or 0, table.data_ptr(), d, indices.data_ptr(), m,
        table.element_size(), *layout, out.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, f"gather_rows (layout {layout})")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_plan_runs(flat: torch.Tensor, run_starts: torch.Tensor,
                     run_lengths: torch.Tensor, out_offsets: torch.Tensor,
                     n_points: int) -> torch.Tensor:
    """Copy each run ``flat[run_starts[r] : run_starts[r] + run_lengths[r]]``
    to ``out[out_offsets[r]:]``, in one launch.

    flat        — (n,) CUDA payload of any dtype of width 1, 2, 4 or 8
    run_starts  — (R,) int32 CUDA, each run inside [0, n)
    run_lengths — (R,) int32 CUDA, each >= 0
    out_offsets — (R + 1,) int64 CUDA, the exclusive prefix of the
                  lengths; ``n_points`` is its last entry (given, so the
                  output is allocated without a read from the card)
    Returns (n_points,).
    """
    dev = _build.cuda_device(flat, "gather_plan_runs payload")
    _build.expect(flat, "gather_plan_runs payload", device=dev,
                  dtype=flat.dtype, shape=(None,))
    _build.expect(run_starts, "gather_plan_runs run starts", device=dev,
                  dtype=torch.int32, shape=(None,))
    n_runs = run_starts.shape[0]
    _build.expect(run_lengths, "gather_plan_runs run lengths", device=dev,
                  dtype=torch.int32, shape=(n_runs,))
    _build.expect(out_offsets, "gather_plan_runs output offsets",
                  device=dev, dtype=torch.int64, shape=(n_runs + 1,))
    out = torch.empty((n_points,), dtype=flat.dtype, device=dev)
    if n_points == 0:
        return out
    lib = _build.library("gather")
    status = lib.polytope_gather_plan_runs(
        dev.index or 0, flat.data_ptr(), run_starts.data_ptr(),
        run_lengths.data_ptr(), out_offsets.data_ptr(), n_runs, n_points,
        flat.element_size(), out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, "gather_plan_runs")
    LAUNCHES["gather_plan_runs"] += 1
    return out


def gather_union_slices(flat: torch.Tensor, union: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """``flat[union[positions]]`` in one launch, the union never
    materialised.

    flat      — (n,) CUDA payload of any dtype of width 1, 2, 4 or 8
    union     — (U,) int32 CUDA offsets into flat, each in [0, n)
    positions — (P,) int32 CUDA positions in union, each in [0, U)
    Returns (P,).
    """
    dev = _build.cuda_device(flat, "gather_union_slices payload")
    _build.expect(flat, "gather_union_slices payload", device=dev,
                  dtype=flat.dtype, shape=(None,))
    _build.expect(union, "gather_union_slices union", device=dev,
                  dtype=torch.int32, shape=(None,))
    _build.expect(positions, "gather_union_slices positions", device=dev,
                  dtype=torch.int32, shape=(None,))
    p = positions.shape[0]
    out = torch.empty((p,), dtype=flat.dtype, device=dev)
    if p == 0:
        return out
    lib = _build.library("gather")
    status = lib.polytope_gather_union_slices(
        dev.index or 0, flat.data_ptr(), union.data_ptr(),
        positions.data_ptr(), p, flat.element_size(), out.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, "gather_union_slices")
    LAUNCHES["gather_union_slices"] += 1
    return out


# Rows narrower than this many bytes take the tiled kernel (csrc/gather.cu
# holds the same as kNarrowRowBytes, and each entry refuses the other's
# rows).
NARROW_ROW_BYTES = 128


def gather_rows_bag(table: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_l table[bags[b, l]]`` on the card, a -1 slot adding
    +0.0, summed in ``l`` order in the table's dtype.

    table — (N, D) float32 or float64 CUDA tensor
    bags  — (B, L) int32 CUDA tensor, each in [-1, N)

    The kernel is chosen by the row's width, not as a fallback: a row of
    fewer than ``NARROW_ROW_BYTES`` bytes (DeepFM's D = 10 and D = 1) takes
    the tiled kernel, a warp per 32 bags (counted under
    ``LAUNCHES["gather_rows_bag_tiled"]``); a wider row (DLRM's D = 64)
    takes a group of lanes per bag (``LAUNCHES["gather_rows_bag"]``).
    Both give the same bytes.
    """
    dev = _build.cuda_device(table, "gather_rows_bag table")
    _build.expect(table, "gather_rows_bag table", device=dev,
                  dtype=(torch.float32, torch.float64), shape=(None, None))
    _build.expect(bags, "gather_rows_bag bags", device=dev,
                  dtype=torch.int32, shape=(None, None))
    b, n_slots = bags.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0 or d == 0:
        return out
    lib = _build.library("gather")
    tiled = d * table.element_size() < NARROW_ROW_BYTES
    name = "gather_rows_bag_tiled" if tiled else "gather_rows_bag"
    status = getattr(lib, f"polytope_{name}")(
        dev.index or 0, table.data_ptr(), d, bags.data_ptr(), b, n_slots,
        table.element_size(), out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, name)
    LAUNCHES[name] += 1
    return out
