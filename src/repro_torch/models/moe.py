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

import itertools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
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
    its group (capacity = t): the decode path.  On a mesh (``x`` a
    ``DTensor``) each rank runs only its own experts (``_moe_mesh``)."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.n_groups, t)
    if t % g:
        g = 1
    if shd.is_dtensor(x):
        return _moe_mesh(params, cfg, x, g, dropless)
    acc, aux = _routed(params["router"], params["w_gate"], params["w_up"],
                       params["w_down"], cfg, x.reshape(g, t // g, d),
                       dropless, 0)
    return _with_shared(params, cfg, x, acc.to(x.dtype).reshape(b, s, d)), \
        aux.mean()


def _with_shared(params: dict, cfg: MoEConfig, x, out):
    """``out`` plus the shared experts' output on ``x`` (DeepSeek)."""
    if not cfg.n_shared:
        return out
    sh = params["shared"]
    return out + swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], x)


def _moe_mesh(params: dict, cfg: MoEConfig, x, g: int, dropless: bool):
    """``moe_ffn`` of a ``DTensor`` ``x`` with ``g`` groups, expert-local.

    Each mesh dim plays one role: "rows" where ``x`` is sharded on its
    rows (the data axes), "experts" where the expert weights are sharded
    on E (``"model"``), "same" where both are whole (every rank there
    computes alike).  Each rank routes whole groups of the plain path
    with the replicated router: its own rows' groups where every rank's
    rows hold whole groups, else every group (the rows gathered over the
    "rows" dims, ``whole_rows``: groups that straddle a shard, and the
    ``t % g`` fallback's one group).  It fills the buffer rows of its
    own E / model experts only, runs the grouped GEMM on them, combines
    their gated outputs in float32 and keeps its own rows; the (T, D)
    partial sums are summed over the "experts" dims, then cast, so no
    rank holds another's experts or their (E, C, D) buffer.  The aux
    loss is the mean over all groups, counted once: a partial sum over
    the "rows" dims where each rank routed its own groups, and only the
    first rank's of the dims where ranks repeat it (the "experts" dims,
    and the "rows" dims after a gather).  Gradients follow the roles
    (``local_of``'s ``grad_placements``): partial sums over "experts"
    for ``x`` and the router, over "rows" for the router and experts."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..kernels._mesh import whole_rows

    b, s, d = x.shape
    t = b * s
    tg = t // g
    mesh = x.device_mesh
    w_gate = params["w_gate"]
    roles = []
    for xp, wp in zip(x.placements, w_gate.placements):
        roles.append("experts" if wp.is_shard(0) else
                     "rows" if xp.is_shard(0) else "same")
    want = [Shard(0) if r == "rows" else Replicate() for r in roles]
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    wants = [Shard(0) if r == "experts" else Replicate() for r in roles]
    experts = [w if tuple(w.placements) == tuple(wants) else
               w.redistribute(mesh, wants)
               for w in (params[k] for k in ("w_gate", "w_up", "w_down"))]

    def grads(rows, experts_):
        return [rows if r == "rows" else experts_ if r == "experts"
                else Replicate() for r in roles]

    r_lo, r_hi = shd.local_range(x, 0)
    pieces = (shd.shard_ranges(b, mesh, x.placements, 0, c)[-1]
              for c in itertools.product(*map(range, mesh.shape)))
    aligned = all(lo * s % tg == 0 and hi * s % tg == 0
                  for lo, hi in pieces)
    x_grad = grads(Shard(0), Partial())
    if aligned:
        xl = shd.local_of(x, x_grad)
    else:
        xl = whole_rows(x, x_grad)
    router = shd.local_of(params["router"], grads(Partial(), Partial()))
    w_loc = [shd.local_of(w, grads(Partial(), Shard(0))) for w in experts]
    e_lo = shd.local_range(experts[0], 0)[0]
    xg = xl.reshape(-1, tg, d)
    acc, aux = _routed(router, *w_loc, cfg, xg, dropless, e_lo)
    if not aligned:
        acc = acc.reshape(t, d)[r_lo * s:r_hi * s]
    out = shd.dtensor_of(acc.reshape(r_hi - r_lo, s, d), mesh,
                         grads(Shard(0), Partial()), (b, s, d))
    out = _with_shared(params, cfg, x, out.redistribute(mesh, want).to(
        x.dtype))

    # The aux loss: this rank's share of the mean over the g groups.
    aux = aux.mean() if xg.shape[0] == g else aux.sum() / g
    coord = mesh.get_coordinate()
    repeats = [j for j, r in enumerate(roles)
               if r == "experts" or (r == "rows" and not aligned)]
    if any(coord[j] for j in repeats):
        aux = torch.zeros_like(aux)
    aux = shd.dtensor_of(aux, mesh, grads(Partial(), Partial()), ())
    return out, aux.redistribute(mesh, [Replicate()] * mesh.ndim)


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


def _routed(router: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, cfg: MoEConfig, xg: torch.Tensor,
            dropless: bool, e_lo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of every group at once: xg (G, T, D) → (the
    gated sum of each token's kept slots (G, T, D) float32, aux (G,)).
    The weights hold experts [e_lo, e_lo + E'), E' = ``w_gate.shape[0]``
    (all E on one card, a rank's own on a mesh): only their slots are
    dispatched, computed and combined, the others' count as zero."""
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    e_n = w_gate.shape[0]
    dev = xg.device
    logits = router_logits({"router": router}, xg)          # (G, T, E)
    r = route(logits, cfg, dropless)
    rows = g * r.capacity                   # each expert's rows, all groups

    # dispatch: expert e's row (group, position) holds its (token, choice);
    # dropped slots, and other ranks' experts', write a spare row past
    # the experts'.
    eid = r.expert_ids.reshape(g, t * k)
    own = r.keep & (eid >= e_lo) & (eid < e_lo + e_n)
    group = torch.arange(g, device=dev)[:, None]
    slot = (eid - e_lo) * rows + group * r.capacity + r.positions
    slot = torch.where(own, slot, e_n * rows)                  # (G, T·k)
    token = (group * t + torch.arange(t * k, device=dev)[None, :] // k)
    buf = xg.new_zeros((e_n * rows + 1, d))
    buf[slot.reshape(-1)] = xg.reshape(g * t, d)[token.reshape(-1)]
    expert_in = buf[:e_n * rows].view(e_n, rows, d)

    # the grouped GEMM: one batched product over experts
    expert_out = swiglu(w_gate, w_up, w_down,
                        expert_in).reshape(e_n * rows, d)

    # combine: each token's kept slots, weighted, summed in choice order
    taken = expert_out[torch.where(own, slot, 0).reshape(-1)]
    weighted = taken.view(g, t, k, d) * r.gates[..., None].to(xg.dtype)
    weighted = torch.where(own.view(g, t, k, 1), weighted, 0)
    acc = weighted[:, :, 0].float()
    for j in range(1, k):
        acc = acc + weighted[:, :, j].float()

    # aux losses (float32), per group
    density = F.one_hot(r.expert_ids[..., 0], e).float().mean(dim=-2)
    router_prob = r.probs.mean(dim=-2)
    lb_loss = e * (density * router_prob).sum(-1)
    z_loss = torch.square(torch.logsumexp(logits, dim=-1)).mean(-1)
    aux = cfg.aux_loss_weight * lb_loss + cfg.z_loss_weight * z_loss
    return acc, aux
