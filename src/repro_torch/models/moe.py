"""Mixture-of-Experts FFN (DeepSeek-V3, Arctic): top-k softmax routing
and GShard capacity dispatch, the JAX package's ``models/moe.py``.

Routing (``route``) makes the JAX package's decisions: softmax over the
experts, the top k of each token (the lower expert first on equal
probabilities, as ``jax.lax.top_k`` orders them), gates renormalised
over the k; each (token, choice), flattened token-major, takes the next
position in its expert's buffer (a cumsum), and positions at or past
the capacity are dropped.  The capacity is the group's token count
``t`` when dropless (the decode path), else
``max(1, int(capacity_factor · t · k / E))``.

The router's logits are float32 (the router weight stays float32 in a
bf16 model).  The softmax and the gates' renormalisation run in float64
and are rounded to float32 once, so the card and the CPU route the same
logits to the same bytes; against XLA's float32 softmax the gates differ
in the last bit or two, and the ids, positions and kept slots agree.

Groups: ``moe_ffn`` routes each of ``g = min(n_groups, B·S)`` groups of
tokens on its own (one group when ``g`` does not divide ``B·S``), as the
JAX package vmaps ``_moe_group``.  Here all groups run at once: the
grouped GEMM is one batched product over experts, ``(E, g·C, D) ×
(E, D, F)``, with the groups folded into each expert's rows, so each
expert's weights are read once a layer (cuBLAS; the JAX package computes
it with ``einsum`` outside any Pallas kernel).  The weights are used as
they are stored: never cast or copied.

The combine: the JAX scatter-add exists for GSPMD sharding.  On one card
each token gathers its kept slots and sums them in choice order, in
float32, rounded to the model's dtype once: the same function, without
atomics, deterministic; its float32 sum order differs from XLA's.  The
shared experts (DeepSeek) are added after, and the aux loss (switch
load balance plus router z-loss) is each group's, averaged over groups.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init, normal


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                     # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0             # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    # GShard grouping: routing and capacity per group of tokens.
    n_groups: int = 1


def moe_init(cfg: MoEConfig, **kw) -> dict:
    """``router`` (D, E) float32 whatever ``kw``'s dtype; ``w_gate``,
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D) drawn normal · 1/√d_in;
    and ``shared`` (D, n_shared·F), (F·n_shared, D) with ``n_shared``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(d, e, **{**kw, "dtype": torch.float32})["w"],
        "w_gate": normal((e, d, f), s, **kw),
        "w_up": normal((e, d, f), s, **kw),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f), **kw),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared"] = {
            "w_gate": normal((d, fs), s, **kw),
            "w_up": normal((d, fs), s, **kw),
            "w_down": normal((fs, d), 1.0 / math.sqrt(f), **kw),
        }
    return p


class Routing(NamedTuple):
    """One routing of groups of T tokens over E experts, top k."""

    probs: torch.Tensor        # (..., T, E) float32 softmax
    gates: torch.Tensor        # (..., T, k) float32, summing to 1
    expert_ids: torch.Tensor   # (..., T, k) int64, by descending prob
    positions: torch.Tensor    # (..., T·k) int64, in its expert's buffer
    keep: torch.Tensor         # (..., T·k) bool, position < capacity
    capacity: int


def route(logits: torch.Tensor, cfg: MoEConfig, dropless: bool
          ) -> Routing:
    """The routing of ``logits`` (..., T, E) float32, each leading index
    a group of its own: the routing lines of the JAX package's
    ``_moe_group``."""
    t, e = logits.shape[-2:]
    k = cfg.top_k
    p64 = torch.softmax(logits.double(), dim=-1)
    probs = p64.float()
    # The top k by a stable descending sort: the lower expert first on
    # equal probabilities, as jax.lax.top_k puts them.
    top, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    top, expert_ids = top[..., :k].double(), expert_ids[..., :k]
    total = top[..., 0]
    for j in range(1, k):                   # a fixed order on every device
        total = total + top[..., j]
    gates = (top / total[..., None]).float()

    capacity = t if dropless else max(1, int(cfg.capacity_factor * t * k
                                             / e))
    eid = expert_ids.reshape(*expert_ids.shape[:-2], t * k)
    onehot = F.one_hot(eid, e)                                # (..., T·k, E)
    pos = torch.cumsum(onehot, dim=-2).gather(-1, eid[..., None])[..., 0] - 1
    return Routing(probs, gates, expert_ids, pos, pos < capacity, capacity)


def moe_ffn(params: dict, cfg: MoEConfig, x: torch.Tensor,
            dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux_loss float32 scalar).

    ``dropless=True`` sizes each expert buffer to hold every token of
    its group (capacity = t): the decode path."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.n_groups, t)
    if t % g:
        g = 1
    out, aux = _moe_group(params, cfg, x.reshape(g, t // g, d), dropless)
    return out.reshape(b, s, d), aux.mean()


def router_logits(params: dict, xg: torch.Tensor) -> torch.Tensor:
    """(..., T, D) → (..., T, E) float32 router logits."""
    return xg.float() @ params["router"]


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` in ``x``'s dtype
    (batched over experts for (E, ...) weights)."""
    h = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    return torch.matmul(F.silu(h) * u, w_down.to(x.dtype))


def _moe_group(params: dict, cfg: MoEConfig, xg: torch.Tensor,
               dropless: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Every group at once: xg (G, T, D) → (out (G, T, D), aux (G,))."""
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits = router_logits(params, xg)                        # (G, T, E)
    r = route(logits, cfg, dropless)
    rows = g * r.capacity                   # each expert's rows, all groups

    # dispatch: expert e's row (group, position) holds its (token, choice);
    # dropped slots write a spare row past the experts'.
    eid = r.expert_ids.reshape(g, t * k)
    group = torch.arange(g, device=dev)[:, None]
    slot = eid * rows + group * r.capacity + r.positions       # (G, T·k)
    slot = torch.where(r.keep, slot, e * rows)
    token = (group * t + torch.arange(t * k, device=dev)[None, :] // k)
    buf = xg.new_zeros((e * rows + 1, d))
    buf[slot.reshape(-1)] = xg.reshape(g * t, d)[token.reshape(-1)]
    expert_in = buf[:e * rows].view(e, rows, d)

    # the grouped GEMM: one batched product over experts
    expert_out = swiglu(params["w_gate"], params["w_up"], params["w_down"],
                        expert_in).reshape(e * rows, d)

    # combine: each token's kept slots, weighted, summed in choice order
    taken = expert_out[torch.where(r.keep, slot, 0).reshape(-1)]
    weighted = taken.view(g, t, k, d) * r.gates[..., None].to(xg.dtype)
    weighted = torch.where(r.keep.view(g, t, k, 1), weighted, 0)
    acc = weighted[:, :, 0].float()
    for j in range(1, k):
        acc = acc + weighted[:, :, j].float()
    out = acc.to(xg.dtype)

    if cfg.n_shared:
        sh = params["shared"]
        out = out + swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], xg)

    # aux losses (float32), per group
    density = F.one_hot(r.expert_ids[..., 0], e).float().mean(dim=-2)
    router_prob = r.probs.mean(dim=-2)
    lb_loss = e * (density * router_prob).sum(-1)
    z_loss = torch.square(torch.logsumexp(logits, dim=-1)).mean(-1)
    aux = cfg.aux_loss_weight * lb_loss + cfg.z_loss_weight * z_loss
    return out, aux
