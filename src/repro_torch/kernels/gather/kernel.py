"""CUDA kernels for exact-byte extraction gathers (``csrc/gather.cu``).

The planner has already computed *which* elements are needed; these
kernels read exactly those elements of the payload on the card, never
the rest of the datacube — the bounding-box baseline would stream the
whole enclosing block.

* ``gather_rows`` (B1) — (N, D) table × (M,) int32 indices → (M, D).
* ``gather_runs`` (B2) — one ``block``-wide contiguous copy per chunk
  start → (C, block), with loads past the end of the payload masked to
  zero (the payload is never padded).

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
