"""Gradient compression: int8 quantisation with error feedback.

``compress_grads`` is a ``compressor`` for
``repro_torch.train.train_state.make_train_step``: the state gains an
``"ef"`` (error-feedback) dict keyed as the gradients, and each step
quantises ``grad + ef`` per tensor to symmetric int8, hands the
dequantised gradient to the optimizer and carries the rounding error
into the next step (error feedback keeps SGD and Adam converging,
Karimireddy et al. '19).

``quantized_psum`` is the all-reduce with an int8 payload over a
process group (NCCL on the card, gloo on the CPU): every rank
quantises against the largest scale of the group, the int8 values are
summed as int32, and the sum is dequantised — one byte an element on
the wire instead of four, the cross-pod gradient reduction pattern.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _scale(x32: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale ``max|x| / 127`` (at least 1e-12 / 127)."""
    return torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values of ``x32 / scale``, rounded half to even, clipped to
    ±127."""
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``scale = max|x| / 127``."""
    x32 = x.float()
    scale = _scale(x32)
    return _quantize(x32, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_grads(grads: dict, state: dict) -> tuple[dict, dict]:
    """Error-feedback int8 compression of the gradients: (the dequantised
    gradients, ``state`` with the new ``"ef"``).  The state passed in is
    not changed: the caller installs the returned one."""
    ef = state.get("ef")
    if ef is None:
        ef = init_error_feedback(grads)
    new_grads, new_ef = {}, {}
    for key, g in grads.items():
        g32 = g.float() + ef[key]
        deq = dequantize_int8(*quantize_int8(g32))
        new_grads[key] = deq.to(g.dtype)
        new_ef[key] = g32 - deq
    return new_grads, {**state, "ef": new_ef}


def quantized_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks of each rank's ``x``, through an
    int8 payload: quantise, take the group's largest scale
    (``all_reduce(MAX)``, so that every rank dequantises alike),
    quantise again against it, ``all_reduce(SUM)`` the values as int32,
    dequantise.  float32, the JAX package's ``quantized_psum`` arithmetic
    (half-to-even rounding, clipped to ±127)."""
    x32 = x.float()
    scale = _scale(x32)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    total = _quantize(x32, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale
