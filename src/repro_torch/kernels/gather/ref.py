"""Plain PyTorch versions of the gather kernels.

The CPU path of ``ops`` and the yardstick ``chip_smoke.py`` holds the
CUDA kernels against on the card.  Same contracts as ``kernel``.

The backward of B1 and B6 (``gather_rows_backward``,
``gather_rows_bag_backward``) is plain PyTorch on every device, as the
JAX package takes the gradient of ``jnp.take`` with XLA's scatter-add:
``grad_out`` added into a dense zero table at the ids with
``index_add_``, which on the card is deterministic, and adds in the
CPU's order, under PyTorch's deterministic algorithms (``_rows_added``).
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


def _rows_added(n_rows: int, ids: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """A dense (n_rows, D) zero table with row ``src[i]`` added at row
    ``ids[i]`` (int64), the adds of a row in the order of ``i``: so on
    the CPU, and on the card in deterministic mode, where ``index_add_``
    sorts the ids stably and walks each row's run, except at D = 1,
    where a warp reduces the run.  A width-1 table is therefore summed
    as width 2 beside a zero column, and the first column returned."""
    d = src.shape[1]
    if d == 1:
        src = torch.cat([src, torch.zeros_like(src)], dim=1)
    grad = src.new_zeros((n_rows, src.shape[1]))
    return grad.index_add_(0, ids, src)[:, :d]


def gather_rows_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """The gradient of ``gather_rows`` with respect to its (N, D) table:
    ``grad[indices[m]] += grad_out[m]``, dense, zero at rows not read."""
    return _rows_added(n_rows, indices.long(), grad_out)


def gather_rows_bag_backward(grad_out: torch.Tensor, bags: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """The gradient of ``gather_rows_bag`` with respect to its (N, D)
    table: ``grad[bags[b, l]] += grad_out[b]`` for every slot, dense,
    zero at rows not read.  A -1 slot is skipped: it adds into a spare
    row N, past the table's rows, so the ids need no compaction (and no
    read back from the card)."""
    n_slots = bags.shape[1]
    ids = torch.where(bags >= 0, bags, n_rows).reshape(-1).long()
    src = grad_out if n_slots == 1 else grad_out.repeat_interleave(
        n_slots, dim=0)
    return _rows_added(n_rows + 1, ids, src)[:n_rows]


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
