"""Public entry points for segment reductions.

The tensor's device decides the path: a CUDA tensor launches the CUDA
kernel (``kernel``, B7), a CPU tensor takes the plain PyTorch version
(``ref``).  There is no fallback between them: a failed build or launch
raises.  ``use_pallas``/``interpret`` keep the JAX package's signature
and are ignored.  The JAX package's ``VMEM_SEGMENT_LIMIT`` dispatch
(the one-hot kernel only while the (S, D) accumulator fits in a TPU
core's VMEM) has no counterpart: B7 runs at every S·D.

``segment_sum`` is differentiable with respect to the messages: its
backward gathers ``grad_out[ids]`` (0 for a ``-1`` id) in plain
PyTorch, as the JAX package takes that gradient with XLA's own gather
and not with a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from .._casting import checked_cast_i32
from . import kernel, ref


def _route(t: torch.Tensor):
    """``kernel`` for a CUDA tensor, ``ref`` for a CPU tensor."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return ref
    raise ValueError(f"no segment path for a tensor on {t.device}")


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _route(messages).segment_sum(messages, segment_ids,
                                            num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        (segment_ids,) = ctx.saved_tensors
        return ref.segment_sum_backward(grad_out, segment_ids), None, None


def segment_sum(messages: torch.Tensor, segment_ids, num_segments: int,
                use_pallas: bool = False,
                interpret: bool = True) -> torch.Tensor:
    """``out[s] = sum of messages[e] over the edges with ids[e] == s`` for
    (E, D) messages and (E,) ids in [-1, num_segments) (a -1 id is
    dropped); kernel B7 on the card.  Each segment adds its edges in
    ascending edge index from +0.0."""
    ids = checked_cast_i32(segment_ids, what="segment_sum segment_ids",
                           n_elements=num_segments, allow_negative_one=True)
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(ids)
    return _SegmentSum.apply(messages, ids.to(messages.device),
                             num_segments)


def segment_max(messages: torch.Tensor, segment_ids, num_segments: int,
                **_) -> torch.Tensor:
    """``out[s] = max of messages[e] over ids[e] == s``, 0 where a
    segment is empty; the plain version on every device (the JAX package
    has no kernel for it either)."""
    return ref.segment_max(messages, segment_ids, num_segments)
