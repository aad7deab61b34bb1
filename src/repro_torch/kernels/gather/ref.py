"""Plain PyTorch versions of the gather kernels.

The CPU path of ``ops`` and the yardstick ``chip_smoke.py`` holds the
CUDA kernels against on the card.  Same contracts as ``kernel``.
"""

from __future__ import annotations

import torch

from .._casting import checked_cast_i32


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    idx = checked_cast_i32(indices, what="gather_rows indices",
                           n_elements=table.shape[0])
    return table[idx.long()]


def gather_runs(flat: torch.Tensor, chunk_starts: torch.Tensor,
                block: int) -> torch.Tensor:
    """Window loads, (C, block), zero where a window runs past the end
    of ``flat`` — equal to a gather from the payload padded by
    ``block`` zeros."""
    n = flat.shape[0]
    starts = checked_cast_i32(chunk_starts, what="gather_runs chunk starts",
                              n_elements=n).long()
    if starts.numel() == 0:
        return flat.new_empty((0, block))
    window = starts[:, None] + torch.arange(block, device=flat.device)
    inside = window < n
    vals = flat[window.clamp(max=n - 1)]
    return torch.where(inside, vals, torch.zeros((), dtype=flat.dtype,
                                                 device=flat.device))
