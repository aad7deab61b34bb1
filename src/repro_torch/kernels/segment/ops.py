"""Public entry points for segment reductions.

The tensor's device decides the path: a CUDA tensor launches the CUDA
kernel (``kernel``, B7), a CPU tensor takes the plain PyTorch version
(``ref``), each registered as the op's kernel for its device.  There
is no fallback between them: a failed build or launch raises.
``use_pallas``/``interpret`` keep the JAX package's signature and are
ignored.  The JAX package's ``VMEM_SEGMENT_LIMIT`` dispatch
(the one-hot kernel only while the (S, D) accumulator fits in a TPU
core's VMEM) has no counterpart: B7 runs at every S·D.

``segment_sum`` is the custom op ``repro_torch::segment_sum`` (a plan's
tensors as its arguments, a fake for ``meta`` and fake tensors),
differentiable any number of times with respect to the messages.  Its
backward is the op ``repro_torch::segment_gather``, the gather
``grad_out[ids]`` (0 for a ``-1`` id) in plain PyTorch, as the JAX
package takes that gradient with XLA's own gather and not with a Pallas
kernel.  The gather's own backward is ``segment_sum`` over the same
plan, kept in the autograd context: the backward of a backward (the
training of forces, ``-∂E/∂positions``) is B7 again on the card, in its
fixed order, with no new host read, no new sort and no atomics.
``segment_gather`` is that gather as an entry point of its own, for a
model that reads node rows at edge ids (its backward is B7).

On a mesh (``DTensor`` edges and node rows) the plan is each rank's
own, and ``segment_sum``/``segment_gather`` run the ops on local
tensors between the row collectives of ``kernels._mesh``.

Plan once, then read: ``segment_plan(ids, n)`` validates the ids (one
host read of their min and max) and groups them by segment (a sort and
a binary search) once; ``segment_sum`` given that plan does neither, and
on the card is one launch of B7's walk.  A model that sums many message
tensors over the same ids (NequIP: every (layer, l) of a forward) builds
one plan per forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...distributed import sharding as shd
from .._build import LAUNCHES
from .._casting import checked_cast_i32
from .._mesh import checked_ids, scatter_rows, whole_rows
from . import kernel, ref
from .ref import SegmentPlan


def _check_device(t: torch.Tensor) -> None:
    """Only CUDA and CPU tensors have a path (the ops' fakes serve fake
    tensors, which report the device they stand for, and ``meta``
    tensors given to an op directly)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no segment path for a tensor on {t.device}")


def _checked_ids(segment_ids, num_segments: int, device) -> torch.Tensor:
    ids = checked_cast_i32(segment_ids, what="segment_sum segment_ids",
                           n_elements=num_segments, allow_negative_one=True)
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(ids)
    return ids.to(device)


def _local_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of ids already checked: of the ids themselves, or, for a
    ``DTensor`` of ids (edges sharded over a mesh), of this rank's own
    ids, keeping the ``DTensor`` (``SegmentPlan.dist``)."""
    if shd.is_dtensor(ids):
        return dataclasses.replace(ref.build_plan(ids.to_local(),
                                                  num_segments), dist=ids)
    return ref.build_plan(ids, num_segments)


def segment_plan(segment_ids, num_segments: int) -> SegmentPlan:
    """Validate (E,) ids in [-1, num_segments) once and group them by
    segment once, on the ids' device (numpy ids: the CPU).  A plan built
    on the card counts one ``LAUNCHES["segment_plan"]``.  For a
    ``DTensor`` of ids the check spans every rank
    (``kernels._mesh.checked_ids``) and each rank groups its own
    ids: one host read and one sort a rank, as on one card."""
    if shd.is_dtensor(segment_ids):
        ids = checked_ids(segment_ids, what="segment_sum segment_ids",
                              n_rows=num_segments, allow_negative_one=True)
    else:
        device = segment_ids.device if isinstance(
            segment_ids, torch.Tensor) else torch.device("cpu")
        ids = _checked_ids(segment_ids, num_segments, device)
    plan = _local_plan(ids, num_segments)
    if plan.ids.device.type == "cuda":
        LAUNCHES["segment_plan"] += 1
    return plan


# -- B7 as custom ops ---------------------------------------------------------
# A plan goes in as its tensors (ids, perm, offsets).  ``segment_sum``
# runs B7 on a CUDA tensor (``kernel``, counted in ``LAUNCHES``) and its
# plain version on a CPU tensor; ``segment_gather`` is the plain gather
# on every device.  Each is the other's backward, so the sums and
# gathers are differentiable any number of times.  The bodies look
# ``kernel.segment_sum`` up at each call, so a caller's stand-in is
# obeyed.
@torch.library.custom_op("repro_torch::segment_sum", mutates_args=(),
                         device_types="cuda")
def segment_sum_op(messages: torch.Tensor, ids: torch.Tensor,
                   perm: torch.Tensor, offsets: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """B7: the (num_segments, D) sums of (E, D) messages over a plan."""
    return kernel.segment_sum(
        messages, SegmentPlan(ids, num_segments, perm, offsets),
        num_segments)


@segment_sum_op.register_kernel("cpu")
def _(messages, ids, perm, offsets, num_segments):
    return ref.segment_sum(
        messages, SegmentPlan(ids, num_segments, perm, offsets),
        num_segments)


@segment_sum_op.register_fake
def _(messages, ids, perm, offsets, num_segments):
    return messages.new_empty((num_segments, messages.shape[1]))


@torch.library.custom_op("repro_torch::segment_gather", mutates_args=())
def segment_gather_op(values: torch.Tensor, ids: torch.Tensor,
                      perm: torch.Tensor, offsets: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``values[ids[e]]`` of (num_segments, D) values for each of the
    (E,) ids, 0 for a -1 id (``ref.segment_sum_backward``)."""
    return ref.segment_sum_backward(values, ids)


@segment_gather_op.register_fake
def _(values, ids, perm, offsets, num_segments):
    return values.new_empty((ids.shape[0], values.shape[1]))


def _save_plan(ctx, inputs, output):
    _, ids, perm, offsets, num_segments = inputs
    ctx.save_for_backward(ids, perm, offsets)
    ctx.num_segments = num_segments


def _segment_sum_grad(ctx, grad_out):
    return (segment_gather_op(grad_out, *ctx.saved_tensors,
                              ctx.num_segments), None, None, None, None)


def _segment_gather_grad(ctx, grad_rows):
    return (segment_sum_op(grad_rows.contiguous(), *ctx.saved_tensors,
                           ctx.num_segments), None, None, None, None)


segment_sum_op.register_autograd(_segment_sum_grad, setup_context=_save_plan)
segment_gather_op.register_autograd(_segment_gather_grad,
                                    setup_context=_save_plan)


def _plan_of(segment_ids, num_segments: int, device) -> SegmentPlan:
    """A given plan, or the plan of the ids (checked here; not counted
    as a ``segment_plan``: B7 groups unplanned ids itself)."""
    if isinstance(segment_ids, SegmentPlan):
        return segment_ids
    if shd.is_dtensor(segment_ids):
        return _local_plan(checked_ids(
            segment_ids, what="segment_sum segment_ids",
            n_rows=num_segments, allow_negative_one=True), num_segments)
    return ref.build_plan(_checked_ids(segment_ids, num_segments, device),
                          num_segments)


def _edge_placements(plan: SegmentPlan, x) -> tuple:
    """The mesh and placements of a plan's ``DTensor`` ids, which the
    edge tensor ``x`` must share."""
    ids = plan.dist
    if not shd.is_dtensor(x) or tuple(x.placements) != tuple(
            ids.placements) or \
            x.device_mesh != ids.device_mesh:
        raise ValueError(f"segment_sum: messages placed "
                         f"{getattr(x, 'placements', None)}, the plan's "
                         f"ids {ids.placements}")
    return ids.device_mesh, tuple(ids.placements)


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
    differs from the plan's raises.

    On a mesh (``DTensor`` messages, edges sharded): each rank sums its
    own edges into all ``num_segments`` rows with B7, and the ranks'
    sums are reduce-scattered to rows sharded as the edges were
    (``kernels._mesh.scatter_rows``; rows are whole where the edges are
    replicated, and rows that do not split evenly over the ranks, as a
    readout's per-graph sums, follow ``DTensor``'s ``torch.chunk``
    layout).  A segment whose edges span ranks is summed in another
    order than on one card."""
    _check_device(messages)
    plan = _plan_of(segment_ids, num_segments, messages.device)
    if plan.dist is None:
        plan.check(messages, num_segments)
        return segment_sum_op(messages, plan.ids, plan.perm, plan.offsets,
                              num_segments)
    from torch.distributed.tensor import Replicate, Shard

    mesh, pls = _edge_placements(plan, messages)
    local = shd.local_of(messages)
    plan.check(local, num_segments)
    out = segment_sum_op(local, plan.ids, plan.perm, plan.offsets,
                         num_segments)
    return scatter_rows(out, mesh, [Shard(0) if p.is_shard() else
                                    Replicate() for p in pls],
                        (num_segments, int(messages.shape[1])))


def segment_gather(values: torch.Tensor, segment_ids,
                   num_segments: int) -> torch.Tensor:
    """``values[ids[e]]`` for each of the (E,) ids, 0 for a ``-1`` id:
    values (num_segments, ...) → (E, ...).  Its backward is
    ``segment_sum`` over the same ids or ``SegmentPlan`` (B7 on the
    card, each segment's rows added in ascending edge order), not an
    atomic scatter-add, so the ids may hold hubs: a -1 id adds nothing
    anywhere.

    On a mesh (a plan of ``DTensor`` ids): the rows are first made whole
    on every rank (``kernels._mesh.whole_rows``, an all-gather of
    the ``DTensor`` ``values``), each rank gathers its own edges' rows,
    and the result is sharded as the edges are; the backward sums each
    rank's edges with B7 and reduce-scatters the rows' gradient back.
    The collectives differentiate again, so forces train on a mesh."""
    plan = _plan_of(segment_ids, num_segments, values.device)
    tail = tuple(values.shape[1:])
    if plan.dist is None:
        rows = segment_gather_op(values.reshape(num_segments, -1), plan.ids,
                                 plan.perm, plan.offsets, num_segments)
        return rows.reshape((rows.shape[0],) + tail)
    ids = plan.dist
    if shd.is_dtensor(values):
        values = whole_rows(values)
    rows = segment_gather_op(values.reshape(num_segments, -1), plan.ids,
                             plan.perm, plan.offsets, num_segments)
    return shd.dtensor_of(rows.reshape((rows.shape[0],) + tail),
                          ids.device_mesh, ids.placements,
                          (int(ids.shape[0]),) + tail)


def segment_max(messages: torch.Tensor, segment_ids, num_segments: int,
                **_) -> torch.Tensor:
    """``out[s] = max of messages[e] over ids[e] == s``, 0 where a
    segment is empty; the plain version on every device (the JAX package
    has no kernel for it either)."""
    return ref.segment_max(messages, segment_ids, num_segments)
