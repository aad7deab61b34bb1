"""CUDA kernels for exact-byte extraction gathers (``csrc/gather.cu``).

The planner has already computed *which* elements are needed; these
kernels read exactly those elements of the payload on the card, never
the rest of the datacube — the bounding-box baseline would stream the
whole enclosing block.

* ``gather_rows`` (B1) — (N, D) table × (M,) int32 indices → (M, D).
* ``gather_runs`` (B2) — one ``block``-wide contiguous copy per chunk
  start → (C, block), with loads past the end of the payload masked to
  zero (the payload is never padded).
* ``gather_rows_bag`` (B6) — EmbeddingBag(sum): (N, D) float32/float64
  table × (B, L) int32 bags padded with -1 → (B, D); two kernels, one
  for narrow rows and one for wide, chosen by the row's width.

Each wrapper checks its tensors, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch is refused, and counts the launch in ``LAUNCHES``.  The indices
arrive already validated and cast by ``ops`` (``checked_cast_i32``).
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` on the card.

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
    lib = _build.library("gather")
    status = lib.polytope_gather_rows(
        dev.index or 0, table.data_ptr(), d, indices.data_ptr(), m,
        table.element_size(), out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_runs(flat: torch.Tensor, chunk_starts: torch.Tensor,
                block: int) -> torch.Tensor:
    """Burst-gather ``block`` contiguous elements per chunk start.

    flat         — (n,) CUDA payload, unpadded: elements at or past n
                   read as zero
    chunk_starts — (C,) int32 CUDA element offsets, each in [0, n)
    Returns (C, block); callers compact the valid prefix of each chunk.
    """
    dev = _build.cuda_device(flat, "gather_runs payload")
    _build.expect(flat, "gather_runs payload", device=dev,
                  dtype=flat.dtype, shape=(None,))
    _build.expect(chunk_starts, "gather_runs chunk starts", device=dev,
                  dtype=torch.int32, shape=(None,))
    if block < 1:
        raise ValueError(f"gather_runs: block must be >= 1, got {block}")
    c = chunk_starts.shape[0]
    out = torch.empty((c, block), dtype=flat.dtype, device=dev)
    if c == 0:
        return out
    lib = _build.library("gather")
    status = lib.polytope_gather_runs(
        dev.index or 0, flat.data_ptr(), flat.shape[0],
        chunk_starts.data_ptr(), c, block, flat.element_size(),
        out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, "gather_runs")
    LAUNCHES["gather_runs"] += 1
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
