"""CUDA kernel for the GNN message aggregation (``csrc/segment_sum.cu``).

* ``segment_sum`` (B7) — (E, D) float32/float64 messages × (E,) int32
  segment ids in [-1, S) → (S, D) sums, each segment's edges added in
  ascending edge index from +0.0.

The kernel walks a segment grouping (``ref.SegmentPlan``: a stable sort
of the ids and a binary search for the offsets, ``ref.segment_csr``),
summing each segment with one group of lanes.  Given a plan, the wrapper
launches the walk alone; given the ids, it builds the grouping first.  It checks its
tensors, allocates the output with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch is refused, and counts
the launch in ``LAUNCHES``.  The ids arrive already validated and cast
by ``ops`` (``checked_cast_i32``).
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import LAUNCHES
from .ref import SegmentPlan, segment_csr


def segment_sum(messages: torch.Tensor, segment_ids, num_segments: int
                ) -> torch.Tensor:
    """``out[s] = sum of messages[e] over ids[e] == s`` on the card.

    messages    — (E, D) float32 or float64 CUDA tensor
    segment_ids — (E,) int32 CUDA tensor, each in [-1, num_segments), or
                  a ``SegmentPlan`` of them built on the same device
    """
    dev = _build.cuda_device(messages, "segment_sum messages")
    _build.expect(messages, "segment_sum messages", device=dev,
                  dtype=(torch.float32, torch.float64), shape=(None, None))
    plan = segment_ids if isinstance(segment_ids, SegmentPlan) else None
    if plan is not None:
        plan.check(messages, num_segments)
    else:
        _build.expect(segment_ids, "segment_sum segment_ids", device=dev,
                      dtype=torch.int32, shape=(messages.shape[0],))
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments {num_segments} < 0")
    d = messages.shape[1]
    out = torch.empty((num_segments, d), dtype=messages.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    # Segment s's edges are perm[offsets[s]:offsets[s + 1]], in order.
    if plan is None:
        perm, offsets = segment_csr(segment_ids, num_segments)
    else:
        perm, offsets = plan.perm, plan.offsets
    lib = _build.library("segment_sum")
    status = lib.polytope_segment_sum(
        dev.index or 0, messages.data_ptr(), d, perm.data_ptr(),
        offsets.data_ptr(), num_segments, messages.element_size(),
        out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, status, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
