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


def gather_rows_bag(table: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag(sum) with -1 padding: ``out[b] = sum_l table[bags[b, l]]``.

    Starts from zeros and adds one bag slot at a time, ``l = 0 .. L-1``,
    a -1 slot adding +0.0: the Pallas kernel's accumulation over its
    sequential ``l`` grid axis, which the CUDA kernel keeps too, so all
    three agree byte for byte.  The sum is in the table's dtype.
    """
    bags = checked_cast_i32(bags, what="gather_rows_bag bags",
                            n_elements=table.shape[0],
                            allow_negative_one=True)
    valid = bags >= 0
    rows = table[bags.clamp(min=0).long()]                  # (B, L, D)
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    out = torch.zeros((bags.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for slot in range(bags.shape[1]):
        out = out + torch.where(valid[:, slot, None], rows[:, slot], zero)
    return out


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


def gather_plan_runs(flat: torch.Tensor, run_starts: torch.Tensor,
                     run_lengths: torch.Tensor, out_offsets: torch.Tensor,
                     n_points: int) -> torch.Tensor:
    """Each run's elements at its output offset: the runs expanded to
    their points (``repeat_interleave`` of the starts plus a ramp that
    restarts at each run's output offset), then one index."""
    lengths = run_lengths.long()
    first = torch.repeat_interleave(run_starts.long(), lengths,
                                    output_size=n_points)
    at = torch.repeat_interleave(out_offsets[:-1], lengths,
                                 output_size=n_points)
    ramp = torch.arange(n_points, device=flat.device) - at
    return flat[first + ramp]


def gather_union_slices(flat: torch.Tensor, union: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """The union read, then the slices of it: ``flat[union][positions]``."""
    return flat[union.long()][positions.long()]
