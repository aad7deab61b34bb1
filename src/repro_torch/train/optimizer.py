"""Optimizers from scratch: AdamW and Adafactor, with the schedule and
the global-norm clip.

The same functions as the JAX package's ``train.optimizer``, written
over flat dicts of tensors keyed by the JAX package's tree paths
(``"bags/tables"``, ``"bot/layers/0/w"``): ``params`` maps each path to
its tensor (a model's ``nn.Parameter``\\s, so an update moves the
model), and the state mirrors the JAX tree leaf for leaf —
``{"m": {path: …}, "v": {path: …}, "step"}`` for AdamW, ``{"f": {path:
{"vr", "vc"} or {"v"}}, "step"}`` for Adafactor — so ``carry`` and the
checkpoints move it across.  ``step`` is a 0-d int32 tensor beside the
parameters: the learning rate and the bias corrections are computed on
that device, with no read back to the host.

This is not ``torch.optim.AdamW``: the update clips inside itself, the
bias corrections are float32 ``b ** step``, ``eps`` is added after the
square root of the corrected ``v``, and weight decay touches only the
tensors with ``ndim >= 2`` (tables and weight matrices, not biases).
The update writes the parameters and the moments in place, and only
after the clip's norm has been taken; nothing in it raises on valid
inputs, so a step that fails before it leaves the state as it was.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

Tree = dict


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"               # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    epsilon1: float = 1e-30
    epsilon2: float = 1e-3


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` of ``lr``; in
    float32 on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm of every leaf together, in float32."""
    leaves = [torch.sum(torch.square(leaf.float()))
              for leaf in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads: Tree, max_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the clip's factor ``min(1, max_norm / norm)``, the norm)."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0), norm


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / norm)``, and the norm."""
    scale, norm = _clip_scale(grads, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm


def _clip_in_place(grads: Tree, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` writing into ``grads`` (a step's own
    gradients; a product rounded to each one's dtype); returns the
    norm."""
    scale, norm = _clip_scale(grads, max_norm)
    for g in grads.values():
        g.mul_(scale)
    return norm


# -- AdamW -----------------------------------------------------------------
def adamw_init(params: Tree) -> dict:
    some = next(iter(params.values()))
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Tree, state: dict,
                 params: Tree) -> tuple[Tree, dict, dict]:
    """One AdamW step.  ``grads`` (the step's own, keyed as ``params``)
    are clipped in place; ``params`` and the state are updated in place
    and returned, with ``{"grad_norm", "lr"}``."""
    gnorm = _clip_in_place(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for key, p in params.items():
        g32 = grads[key].float()
        m, v = state["m"][key], state["v"][key]
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        delta = torch.div(m, bc1)
        delta.div_(torch.div(v, bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.sub_(delta.mul_(lr))      # in float32, rounded to p's dtype
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# -- Adafactor ----------------------------------------------------------------
def adafactor_init(params: Tree) -> dict:
    def factored(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    some = next(iter(params.values()))
    return {"f": {k: factored(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads: Tree, state: dict,
                     params: Tree) -> tuple[Tree, dict, dict]:
    """One Adafactor step: second moments factored over the last two
    axes of every ``ndim >= 2`` tensor, the update clipped to RMS 1.
    In place, as ``adamw_update``."""
    gnorm = _clip_in_place(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay_rate)
    for key, p in params.items():
        g32 = grads[key].float()
        f = state["f"][key]
        g2 = torch.square(g32) + cfg.epsilon1
        if p.ndim >= 2:
            vr, vc = f["vr"], f["vc"]
            vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=cfg.epsilon1)
            upd = g32 / (torch.sqrt(rfac)[..., None]
                         * torch.sqrt(vc)[..., None, :] + cfg.epsilon2)
        else:
            v = f["v"]
            v.copy_(beta2 * v + (1 - beta2) * g2)
            upd = g32 / (torch.sqrt(v) + cfg.epsilon2)
        # update clipping (Adafactor's RMS rule)
        rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
        upd = upd / torch.clamp(rms, min=1.0)
        if p.ndim >= 2:
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def make_optimizer(cfg: OptimizerConfig) -> tuple[Callable, Callable]:
    """(init(params) → state, update(grads, state, params) → (params,
    state, metrics)) for ``cfg.kind``."""
    if cfg.kind == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if cfg.kind == "adafactor":
        return adafactor_init, \
            lambda g, s, p: adafactor_update(cfg, g, s, p)
    raise ValueError(cfg.kind)
