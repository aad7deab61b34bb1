"""Plain PyTorch versions of the segment reductions.

The CPU path of ``ops`` and the yardstick ``chip_smoke.py`` holds the
CUDA kernel against on the card.  Same contracts as ``kernel``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .._casting import checked_cast_i32


@dataclass(frozen=True, eq=False)
class SegmentPlan:
    """A segment grouping built once and read by every sum over the same
    ids (``ops.segment_plan`` builds it): the validated int32 ``ids``
    (E,), ``num_segments``, and their CSR ``perm`` (E,) and ``offsets``
    (S + 1,), int64, as ``segment_csr`` gives them, all on one device.
    A plan of a ``DTensor`` of ids (edges sharded over a mesh) holds this
    rank's own ids and their grouping, and the ``DTensor`` as ``dist``
    (``ops.segment_plan``); ``dist`` is None on one device."""

    ids: torch.Tensor
    num_segments: int
    perm: torch.Tensor
    offsets: torch.Tensor
    dist: Any = None

    def check(self, messages: torch.Tensor, num_segments: int) -> None:
        """Raise unless this plan is for ``num_segments`` segments over
        the E rows of ``messages``, on their device."""
        if num_segments != self.num_segments:
            raise ValueError(f"segment_sum: num_segments {num_segments}, "
                             f"the plan has {self.num_segments}")
        if messages.dim() != 2 or messages.shape[0] != self.ids.shape[0]:
            raise ValueError(f"segment_sum: messages "
                             f"{tuple(messages.shape)} against a plan of "
                             f"{self.ids.shape[0]} ids: expected (E, D)")
        if messages.device != self.ids.device:
            raise ValueError(f"segment_sum: messages on {messages.device}, "
                             f"the plan on {self.ids.device}")


def build_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of int32 ``ids`` already validated by the caller."""
    return SegmentPlan(ids, num_segments, *segment_csr(ids, num_segments))


def segment_csr(segment_ids: torch.Tensor, num_segments: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edges grouped by segment: ``(perm, offsets)``, both int64,
    with segment ``s``'s edges at ``perm[offsets[s]:offsets[s + 1]]`` in
    ascending edge index (a stable sort).  ``-1`` ids sort first and lie
    before ``offsets[0]``.  The CUDA kernel's wrapper builds the same."""
    sorted_ids, perm = torch.sort(segment_ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=segment_ids.dtype,
                          device=segment_ids.device)
    return perm, torch.searchsorted(sorted_ids, bounds)


def segment_sum(messages: torch.Tensor, segment_ids, num_segments: int
                ) -> torch.Tensor:
    """``out[s] = sum of messages[e] over the edges with ids[e] == s``;
    ``-1`` ids are dropped and an empty segment is +0.0.  ``segment_ids``
    is the (E,) ids or a ``SegmentPlan`` of them, whose CSR is then used
    as it is.

    Each segment adds its edges in ascending edge index, starting from
    +0.0, in the messages' dtype: the order of a sequential loop, of
    ``jax.ops.segment_sum`` on the CPU and of the CUDA kernel, so all
    agree byte for byte.  Vectorised rank by rank: the segments are put
    in order of falling edge count, so those with a k-th edge are a
    prefix, and step k adds the k-th edge of each of them.
    """
    if isinstance(segment_ids, SegmentPlan):
        plan = segment_ids
        plan.check(messages, num_segments)
    else:
        ids = checked_cast_i32(segment_ids, what="segment_sum segment_ids",
                               n_elements=num_segments,
                               allow_negative_one=True)
        if messages.dim() != 2 or messages.shape[0] != ids.shape[0]:
            raise ValueError(f"segment_sum: messages "
                             f"{tuple(messages.shape)} and ids "
                             f"{tuple(ids.shape)}: expected (E, D) and (E,)")
        plan = None
    d = messages.shape[1]
    out = messages.new_zeros((num_segments, d))
    if num_segments == 0 or messages.shape[0] == 0:
        return out
    if plan is None:
        plan = build_plan(ids, num_segments)
    perm, offsets = plan.perm, plan.offsets
    counts = offsets[1:] - offsets[:-1]
    by_count = torch.sort(counts, descending=True, stable=True).indices
    max_count = int(counts.max())
    # n_active[k]: the number of segments with more than k edges.
    n_active = (num_segments - torch.cumsum(
        torch.bincount(counts, minlength=max_count + 1), 0))[:max_count]
    starts = offsets[:-1][by_count]
    acc = messages.new_zeros((num_segments, d))
    for k, n in enumerate(n_active.tolist()):
        acc[:n] += messages[perm[starts[:n] + k]]
    out[by_count] = acc
    return out


def segment_sum_backward(grad_out: torch.Tensor,
                         segment_ids: torch.Tensor) -> torch.Tensor:
    """The gradient of ``segment_sum`` with respect to the messages:
    ``grad_out[ids[e]]`` for each edge, 0 for a ``-1`` id."""
    rows = grad_out[segment_ids.clamp(min=0).long()]
    return torch.where((segment_ids >= 0)[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def segment_max(messages: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max of messages[e] over the edges with ids[e] == s``;
    ``-1`` ids are dropped, and an empty segment (or one whose maximum
    is not finite) is 0.  A maximum does not depend on the order."""
    ids = torch.as_tensor(segment_ids, device=messages.device)
    valid = ids >= 0
    neg = torch.full((), -torch.inf, dtype=messages.dtype,
                     device=messages.device)
    msg = torch.where(valid[:, None], messages, neg)
    seg = torch.where(valid, ids, 0).long()
    out = torch.full((num_segments, messages.shape[1]), -torch.inf,
                     dtype=messages.dtype, device=messages.device)
    out.scatter_reduce_(0, seg[:, None].expand_as(msg), msg, reduce="amax")
    return torch.where(torch.isfinite(out), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
