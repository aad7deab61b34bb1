"""Gradient compression: int8 quantisation with error feedback.

``compress_grads`` is a ``compressor`` for
``repro_torch.train.train_state.make_train_step``: the state gains an
``"ef"`` (error-feedback) dict keyed as the gradients, and each step
quantises ``grad + ef`` per tensor to symmetric int8, hands the
dequantised gradient to the optimizer and carries the rounding error
into the next step (error feedback keeps SGD and Adam converging,
Karimireddy et al. '19).  On one card nothing is reduced across devices;
the JAX package's ``quantized_psum`` (the int8 all-reduce inside a
mesh) waits for the distribution slice (ROADMAP §A, A10e).
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``scale = max|x| / 127`` (at
    least 1e-12 / 127), rounded half to even and clipped to ±127."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


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
