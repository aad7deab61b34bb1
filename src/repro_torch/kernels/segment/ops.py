"""Public entry points for segment reductions.

The tensor's device decides the path: a CUDA tensor launches the CUDA
kernel (``kernel``, B7), a CPU tensor takes the plain PyTorch version
(``ref``).  There is no fallback between them: a failed build or launch
raises.  ``use_pallas``/``interpret`` keep the JAX package's signature
and are ignored.  The JAX package's ``VMEM_SEGMENT_LIMIT`` dispatch
(the one-hot kernel only while the (S, D) accumulator fits in a TPU
core's VMEM) has no counterpart: B7 runs at every S·D.

``segment_sum`` is differentiable any number of times with respect to
the messages.  Its backward is ``_SegmentGather``, the gather
``grad_out[ids]`` (0 for a ``-1`` id) in plain PyTorch, as the JAX
package takes that gradient with XLA's own gather and not with a Pallas
kernel.  The gather's own backward is ``segment_sum`` over the same ids
or plan, kept in the autograd context: the backward of a backward (the
training of forces, ``-∂E/∂positions``) is B7 again on the card, in its
fixed order, with no new host read, no new sort and no atomics.
``segment_gather`` is that gather as an entry point of its own, for a
model that reads node rows at edge ids (its backward is B7).

Plan once, then read: ``segment_plan(ids, n)`` validates the ids (one
host read of their min and max) and groups them by segment (a sort and
a binary search) once; ``segment_sum`` given that plan does neither, and
on the card is one launch of B7's walk.  A model that sums many message
tensors over the same ids (NequIP: every (layer, l) of a forward) builds
one plan per forward.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LAUNCHES
from .._casting import checked_cast_i32
from . import kernel, ref
from .ref import SegmentPlan


def _route(t: torch.Tensor):
    """``kernel`` for a CUDA tensor, ``ref`` for a CPU tensor."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return ref
    raise ValueError(f"no segment path for a tensor on {t.device}")


def _checked_ids(segment_ids, num_segments: int, device) -> torch.Tensor:
    ids = checked_cast_i32(segment_ids, what="segment_sum segment_ids",
                           n_elements=num_segments, allow_negative_one=True)
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(ids)
    return ids.to(device)


def segment_plan(segment_ids, num_segments: int) -> SegmentPlan:
    """Validate (E,) ids in [-1, num_segments) once and group them by
    segment once, on the ids' device (numpy ids: the CPU).  A plan built
    on the card counts one ``LAUNCHES["segment_plan"]``."""
    device = segment_ids.device if isinstance(segment_ids, torch.Tensor) \
        else torch.device("cpu")
    plan = ref.build_plan(_checked_ids(segment_ids, num_segments, device),
                          num_segments)
    if device.type == "cuda":
        LAUNCHES["segment_plan"] += 1
    return plan


class _SegmentSum(torch.autograd.Function):
    """``segment_sum`` of the messages; its backward is ``_SegmentGather``
    over the same ids or plan."""

    @staticmethod
    def forward(ctx, messages, ids_or_plan, num_segments):
        ctx.ids_or_plan, ctx.num_segments = ids_or_plan, num_segments
        return _route(messages).segment_sum(messages, ids_or_plan,
                                            num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        return _SegmentGather.apply(grad_out, ctx.ids_or_plan,
                                    ctx.num_segments), None, None


class _SegmentGather(torch.autograd.Function):
    """``grad_out[ids]`` for each edge, 0 for a ``-1`` id (the plain
    ``ref.segment_sum_backward``); its backward is ``segment_sum`` over
    the same ids or plan."""

    @staticmethod
    def forward(ctx, grad_out, ids_or_plan, num_segments):
        ctx.ids_or_plan, ctx.num_segments = ids_or_plan, num_segments
        ids = ids_or_plan.ids if isinstance(ids_or_plan, SegmentPlan) \
            else ids_or_plan
        return ref.segment_sum_backward(grad_out, ids)

    @staticmethod
    def backward(ctx, grad_rows):
        return _SegmentSum.apply(grad_rows.contiguous(), ctx.ids_or_plan,
                                 ctx.num_segments), None, None


def segment_sum(messages: torch.Tensor, segment_ids, num_segments: int,
                use_pallas: bool = False,
                interpret: bool = True) -> torch.Tensor:
    """``out[s] = sum of messages[e] over the edges with ids[e] == s`` for
    (E, D) messages and (E,) ids in [-1, num_segments) (a -1 id is
    dropped); kernel B7 on the card.  Each segment adds its edges in
    ascending edge index from +0.0.

    ``segment_ids`` is the ids (tensor or numpy), validated and grouped
    in this call, or a ``SegmentPlan`` from ``segment_plan``: then no
    host read and no sort, and a ``num_segments``, E or device that
    differs from the plan's raises."""
    if isinstance(segment_ids, SegmentPlan):
        segment_ids.check(messages, num_segments)
        return _SegmentSum.apply(messages, segment_ids, num_segments)
    return _SegmentSum.apply(
        messages, _checked_ids(segment_ids, num_segments, messages.device),
        num_segments)


def segment_gather(values: torch.Tensor, segment_ids,
                   num_segments: int) -> torch.Tensor:
    """``values[ids[e]]`` for each of the (E,) ids, 0 for a ``-1`` id:
    values (num_segments, ...) → (E, ...).  Its backward is
    ``segment_sum`` over the same ids or ``SegmentPlan`` (B7 on the
    card, each segment's rows added in ascending edge order), not an
    atomic scatter-add, so the ids may hold hubs: a -1 id adds nothing
    anywhere."""
    rows = _SegmentGather.apply(values.reshape(num_segments, -1),
                                segment_ids, num_segments)
    return rows.reshape((rows.shape[0],) + tuple(values.shape[1:]))


def segment_max(messages: torch.Tensor, segment_ids, num_segments: int,
                **_) -> torch.Tensor:
    """``out[s] = max of messages[e] over ids[e] == s``, 0 where a
    segment is empty; the plain version on every device (the JAX package
    has no kernel for it either)."""
    return ref.segment_max(messages, segment_ids, num_segments)
