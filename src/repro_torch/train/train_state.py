"""Train state and the generic train-step factory.

``make_train_step`` turns any ``loss_fn(params, batch) → (loss,
metrics)`` into ``step(state, batch) → (state, metrics)`` with gradient
accumulation and optional int8 error-feedback gradient compression, as
the JAX package's ``train.train_state`` does.  ``params`` is a flat dict
of tensors keyed by the JAX package's tree paths (a model's parameters:
``carry.model_params``), and the loss reads them through the model, so
the step updates them in place and returns the same state dict.

Everything that can fail on bad inputs — the data, the forward, the
backward, the compressor — runs before the first write to the state;
the optimizer's in-place update comes last.  A step that raises
therefore leaves the state as it was, and ``train.fault.Supervisor`` may
replay it from memory.

The state and the batch may be ``DTensor`` tensors on a mesh
(``distributed.sharding.named``): the step is then the same plain torch
ops, which ``torch.distributed.tensor`` runs shard by shard, and each
gradient is reduced to its parameter's placements (a ``Partial`` sum
over the batch's ranks all-reduced, or reduce-scattered onto a
sharded parameter) before the optimizer reads it.  As in the
JAX package, each microbatch is pinned back onto the batch axes
(``distributed.context.constrain``), which the reshape would otherwise
move to the small accumulation axis; on plain tensors that is a no-op.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..distributed import sharding as shd
from ..distributed.context import DP, constrain
from .optimizer import OptimizerConfig, make_optimizer


def init_train_state(params: dict, opt_cfg: OptimizerConfig) -> dict:
    opt_init, _ = make_optimizer(opt_cfg)
    return {"params": params, "opt": opt_init(params)}


def value_and_grad(loss_fn: Callable, params: dict, batch: Any
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, gradients keyed as ``params``) of one batch; a
    parameter the loss does not reach gets a zero gradient.  A parameter
    tensor that does not require a gradient yet is switched to.  Each
    gradient is a tensor of its own, which the optimizer may write in
    place: autograd may hand two parameters one tensor (``a + b``) or a
    broadcast view (``p.sum()``), and those are copied."""
    for p in params.values():
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        leaves = list(params.values())
        raw = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads, seen = {}, set()
    for (k, p), g in zip(params.items(), raw):
        if g is None:
            g = torch.zeros_like(p)
        elif shd.is_dtensor(g) and tuple(g.placements) != tuple(
                p.placements):
            # On a mesh: a partial sum over the ranks that split the
            # batch (or another layout) reduced to the parameter's own.
            g = g.redistribute(p.device_mesh, p.placements)
        if id(g) in seen or not g.is_contiguous():
            g = g.clone(memory_format=torch.contiguous_format)
        seen.add(id(g))
        grads[k] = g
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatches(batch: Any, accum_steps: int) -> Any:
    """The batch as (accum_steps, B / accum_steps, ...) along the leading
    axis, each microbatch kept on the batch axes."""
    if isinstance(batch, dict):
        return {k: _microbatches(v, accum_steps) for k, v in batch.items()}
    micro = shd.unflatten(batch, 0, (accum_steps,
                                     batch.shape[0] // accum_steps))
    return constrain(micro, None, DP, *([None] * (batch.ndim - 1)))


def _take(micro: Any, i: int) -> Any:
    """Microbatch ``i`` of ``_microbatches``."""
    if isinstance(micro, dict):
        return {k: _take(v, i) for k, v in micro.items()}
    return micro[i]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    accum_steps: int = 1,
                    compressor: Callable | None = None) -> Callable:
    """``loss_fn(params, batch) → (loss, metrics dict)``.  The step's
    metrics are ``loss``, ``grad_norm``, ``lr`` and the loss's own, as
    0-d tensors on the parameters' device (no read back)."""
    _, opt_update = make_optimizer(opt_cfg)

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            # Microbatches over the leading axis, their gradients summed
            # in the parameters' dtype, then divided by the count.
            grads = {k: torch.zeros_like(
                         p, memory_format=torch.contiguous_format)
                     for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            metricss = []
            micro = _microbatches(batch, accum_steps)
            for i in range(accum_steps):
                loss, metrics, g = value_and_grad(loss_fn, params,
                                                  _take(micro, i))
                for k, a in grads.items():
                    a.add_(g[k].to(a.dtype))
                lsum = lsum + loss
                metricss.append(metrics)
            loss = lsum / accum_steps
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricss]))
                       for k in metricss[0]}
            grads = {k: g / accum_steps for k, g in grads.items()}

        new_state = state
        if compressor is not None:
            grads, new_state = compressor(grads, state)

        _, _, opt_metrics = opt_update(grads, state["opt"], params)
        state.update({k: v for k, v in new_state.items()
                      if k not in ("params", "opt")})
        return state, {"loss": loss, **metrics, **opt_metrics}

    return step
