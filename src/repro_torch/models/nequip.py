"""NequIP — E(3)-equivariant message passing [arXiv:2101.03164].

Irrep regime: node features are per-l real-spherical-harmonic channels
``{l: (N, C, 2l+1)}``; messages are channel-wise tensor products of
neighbour features with ``Y_l(r̂_ij)``, contracted through **Gaunt
coefficient** tensors ``G[m1, m2, m3] = ∫ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3}
dΩ``, computed numerically exactly at build time with Gauss–Legendre ×
uniform-φ quadrature (the integrand is band-limited, so the quadrature
is exact).  ``gaunt``, ``sph_harm_np`` and ``tp_paths`` are numpy copies
of the JAX package's; ``sph_harm`` and ``bessel_rbf`` act on tensors.

Message passing is a segment sum over the edge list: every layer's
aggregation (one per ``l``) and the per-graph energy readout go through
``kernels.segment.ops.segment_sum``, which is kernel B7 on the card and
its plain version on CPU tensors.  A node-class forward launches B7
``n_layers × (l_max + 1)`` times, an energy forward once more.  The
layers' sums share one ``segment_plan`` of the destination ids, built
once per forward (the ids validated and grouped by node once), and the
readout has one of the graph ids.  The layers read source rows through
``segment_gather`` over a plan of the source ids, so the gathers'
backward is B7 as well: 2 plans a node-class forward, 3 an energy
forward.

The forward follows the JAX package's ``nequip_forward`` step for step,
with these differences, none of which changes what it computes:

* On a mesh the model takes ``DTensor`` tensors: nodes and edges sharded
  over ``GRAPH_AXES``, the parameters replicated.  ``constrain`` pins
  the edge messages, the message sums and each layer's features there,
  at the JAX package's three places.  Every edge's geometry and every
  message sum run on the rank that holds the edge, on its local tensors
  (B7 on its own edges, then a reduce-scatter of the sums; the source
  rows and positions all-gathered first), through collectives that
  differentiate again, so forces train sharded too.
* The JAX package's ``jax.checkpoint`` of each layer is
  ``torch.utils.checkpoint`` (non-reentrant) in training
  (``remat``, which ``nequip_loss`` sets): each layer's edge messages
  are recomputed in the backward pass instead of kept.  Serving, forces
  included, runs the layers once, as before.
* The filter of each path, ``Y_lf(r̂) · G``, depends only on the edge,
  so it is contracted once per forward instead of once per layer; the
  tensor product is then a batched product per edge.  The channel mix
  is applied to the edge messages before the sum, as in the JAX
  package, with the sum taken in (m, channel) order and transposed
  after.  Float32 results differ from XLA's einsum order in the last
  bits only.
* Padding edges (``src`` or ``dst`` = -1) are clamped to node 0 for the
  geometry and their messages are zeroed by the edge mask, as in the
  JAX package, but they enter the sums and the source gathers with id
  -1 (dropped, read as 0) rather than as node 0's edges.  A zero
  message added to a sum that starts at +0.0 never changes it (the sum
  is never -0.0), so every output is the same to the bit, and node 0
  does not become a hub of all the padding edges (80,405 of the 168,960
  of a ``minibatch_lg`` batch), in the sums or in the gathers' backward.

Forces (``nequip_energy_forces``) are ``-∂E/∂positions`` through
``torch.autograd.grad``; B7's backward is the gather ``grad_out[ids]``,
and that gather's backward is B7 again, so ``create_graph=True`` keeps
the forces differentiable for training (``nequip_loss``'s energy +
forces branch), as ``jax.value_and_grad`` inside the JAX loss is.

Parameters keep the JAX parameter tree's layout (``embed``, ``readout``
and per layer ``radial``, ``mix``, ``self``, ``gate``, keyed by
``str(l)``); ``self`` is the attribute ``self_interaction``, since
``self`` names the module in its methods.  ``repro_torch.carry``
loads a JAX tree into this module.  Matrix products run at whatever
float32 matmul precision the process has set: the model never sets it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device, seeded_generator
from ..distributed import sharding as shd
from ..distributed.context import GRAPH_AXES, constrain
from ..kernels._mesh import whole_rows
from ..kernels.segment import ops as segment_ops
from .layers import MLP


# ---------------------------------------------------------------------------
# real spherical harmonics (l <= 2), unit vectors
# ---------------------------------------------------------------------------
def sph_harm_np(l: int, v: np.ndarray) -> np.ndarray:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.full(v.shape[:-1] + (1,), 0.2820947917738781)
    if l == 1:
        c = 0.4886025119029199
        return np.stack([c * y, c * z, c * x], -1)
    if l == 2:
        c1, c2, c3 = 1.0925484305920792, 0.31539156525252005, \
            0.5462742152960396
        return np.stack([c1 * x * y, c1 * y * z,
                         c2 * (3 * z ** 2 - 1.0),
                         c1 * x * z, c3 * (x ** 2 - y ** 2)], -1)
    raise NotImplementedError(l)


def sph_harm(l: int, v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return torch.full_like(v[..., :1], 0.2820947917738781)
    if l == 1:
        c = 0.4886025119029199
        return torch.stack([c * y, c * z, c * x], -1)
    if l == 2:
        c1, c2, c3 = 1.0925484305920792, 0.31539156525252005, \
            0.5462742152960396
        return torch.stack([c1 * x * y, c1 * y * z,
                            c2 * (3 * z ** 2 - 1.0),
                            c1 * x * z, c3 * (x ** 2 - y ** 2)], -1)
    raise NotImplementedError(l)


@functools.lru_cache(maxsize=None)
def gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    """G[m1, m2, m3] = ∫ Y_{l1m1} Y_{l2m2} Y_{l3m3} dΩ (exact quadrature).

    Gauss–Legendre (cosθ, order 24) × uniform φ (64 nodes) integrates
    band-limited spherical polynomials of total degree ≤ 6 exactly.
    """
    nodes, weights = np.polynomial.legendre.leggauss(24)
    phi = 2 * np.pi * (np.arange(64) + 0.5) / 64
    ct, ph = np.meshgrid(nodes, phi, indexing="ij")       # (24, 64)
    st = np.sqrt(1 - ct ** 2)
    v = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1)
    w = np.broadcast_to(weights[:, None] * (2 * np.pi / 64),
                        (24, 64)).ravel()
    v = v.reshape(-1, 3)
    y1, y2, y3 = (sph_harm_np(l, v) for l in (l1, l2, l3))
    g = np.einsum("q,qa,qb,qc->abc", w, y1, y2, y3)
    g[np.abs(g) < 1e-12] = 0.0
    return g.astype(np.float32)


def tp_paths(l_max: int) -> list[tuple[int, int, int]]:
    """All (l_in, l_filter, l_out) with non-vanishing Gaunt coupling."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2 == 0 and np.abs(
                        gaunt(l1, l2, l3)).max() > 1e-8:
                    out.append((l1, l2, l3))
    return out


# ---------------------------------------------------------------------------
def bessel_rbf(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis [DimeNet] with p=6 polynomial envelope."""
    r = torch.clamp(r, min=1e-6)
    k = shd.replicate_like(torch.arange(1, n + 1, dtype=r.dtype,
                                        device=r.device), r)
    rb = math.sqrt(2.0 / cutoff) * torch.sin(k * math.pi * r[..., None]
                                             / cutoff) / r[..., None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    p = 6
    env = (1 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    return rb * env[..., None]


@dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16              # input node feature dim
    n_out: int = 1                # classes or 1 (energy)
    readout: str = "energy"       # "energy" | "node_class"
    radial_hidden: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def ls(self) -> tuple[int, ...]:
        return tuple(range(self.l_max + 1))

    @property
    def paths(self) -> list[tuple[int, int, int]]:
        return tp_paths(self.l_max)


def _normal(shape: tuple[int, int], scale: float, kw: dict) -> nn.Parameter:
    w = torch.empty(shape, dtype=kw["dtype"], device=kw["device"])
    return nn.Parameter(w.normal_(0.0, scale, generator=kw["generator"]))


def _geometry(cfg: NequIPConfig, positions: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, edge_mask: torch.Tensor) -> tuple:
    """Each edge's ``Y_l(r̂)`` (a dict by l), radial basis and mask:
    padding ids clamped to node 0, as in the JAX package."""
    rel = positions[src.clamp(min=0).long()] - \
        positions[dst.clamp(min=0).long()]                # (E, 3)
    r = torch.linalg.norm(rel + 1e-12, dim=-1)
    rhat = rel / torch.clamp(r, min=1e-6)[:, None]
    ys = {l: sph_harm(l, rhat).to(cfg.dtype) for l in cfg.ls}
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    emask = (edge_mask & (r <= cfg.cutoff)).to(cfg.dtype)
    return ys, rbf, emask


def _edge_geometry(cfg: NequIPConfig, positions: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor,
                   edge_mask: torch.Tensor) -> tuple:
    """``_geometry``.  On a mesh (``DTensor`` node rows and edges), the
    positions are made whole on every rank (an all-gather of (N, 3)),
    each rank computes its own edges' geometry on its local tensors, and
    the results are sharded as the edges are; the positions' gradient
    (forces) is each rank's, reduce-scattered back.  Per-edge work never
    leaves its rank."""
    if not shd.is_dtensor(src):
        return _geometry(cfg, positions, src, dst, edge_mask)
    mesh, pls = src.device_mesh, src.placements
    ys, rbf, emask = _geometry(cfg, whole_rows(positions), src.to_local(),
                               dst.to_local(), edge_mask.to_local())
    e = int(src.shape[0])

    def edges(t):
        return shd.dtensor_of(t, mesh, pls, (e,) + tuple(t.shape[1:]))

    return {l: edges(y) for l, y in ys.items()}, edges(rbf), edges(emask)


def _zeros_like_rows(like: torch.Tensor, shape: tuple,
                     dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; on a mesh, a ``DTensor``
    whose dim 0 is placed as ``like``'s (node rows)."""
    if not shd.is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros

    return zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                 placements=like.placements)


class NequIPLayer(nn.Module):
    """One interaction layer: radial MLP → per-(path, channel) weights,
    tensor-product messages, channel mix, segment sum, self-interaction,
    SiLU on l = 0 and sigmoid gates on l > 0."""

    def __init__(self, cfg: NequIPConfig, **kw):
        super().__init__()
        c = cfg.channels
        self.cfg = cfg
        self.radial = MLP([cfg.n_rbf, cfg.radial_hidden,
                           len(cfg.paths) * c], **kw)
        self.mix = nn.ParameterDict()
        self.self_interaction = nn.ParameterDict()
        self.gate = nn.ParameterDict()
        for l in cfg.ls:
            n_in_paths = sum(1 for (_, _, lo) in cfg.paths if lo == l)
            if n_in_paths == 0:
                continue
            self.mix[str(l)] = _normal((n_in_paths * c, c),
                                       1.0 / math.sqrt(n_in_paths * c), kw)
            self.self_interaction[str(l)] = _normal(
                (c, c), 1.0 / math.sqrt(c), kw)
            if l > 0:
                self.gate[str(l)] = _normal((c, c), 1.0 / math.sqrt(c), kw)

    def forward(self, feats: dict, filters: list, rbf: torch.Tensor,
                emask: torch.Tensor, src: segment_ops.SegmentPlan,
                seg: segment_ops.SegmentPlan) -> dict:
        cfg, c = self.cfg, self.cfg.channels
        n, e = feats[0].shape[0], rbf.shape[0]
        radial_w = self.radial(rbf)                      # (E, paths*C)
        h_src = {l: segment_ops.segment_gather(feats[l], src, n)
                 for l in cfg.ls}                        # (E, C, 2l+1)
        msgs: dict[int, list] = {l: [] for l in cfg.ls}
        for pi, (li, _, lo) in enumerate(cfg.paths):
            msg = torch.bmm(h_src[li], filters[pi])      # (E, C, 2lo+1)
            w = radial_w[:, pi * c:(pi + 1) * c]         # (E, C)
            msgs[lo].append(msg * (w * emask[:, None])[..., None])
        new_feats = {}
        for l in cfg.ls:
            if not msgs[l]:
                new_feats[l] = feats[l]
                continue
            msg = constrain(torch.cat(msgs[l], dim=1),   # (E, P·C, 2l+1)
                            GRAPH_AXES, None, None)
            # "epm,pc->ecm" as (E, 2l+1, P·C) @ (P·C, C): summed in
            # (m, channel) order, transposed after the sum.
            msg_mixed = torch.matmul(msg.transpose(1, 2),
                                     self.mix[str(l)])
            mixed = segment_ops.segment_sum(
                msg_mixed.reshape(e, -1), seg, n).view(
                    n, 2 * l + 1, c).transpose(1, 2)
            mixed = constrain(mixed, GRAPH_AXES, None, None)
            self_c = torch.einsum("ncm,cd->ndm", feats[l],
                                  self.self_interaction[str(l)])
            h = mixed + self_c
            if l == 0:
                h = torch.nn.functional.silu(h)
            else:
                gate = torch.sigmoid(feats[0][..., 0] @ self.gate[str(l)])
                h = h * gate[..., None]
            new_feats[l] = constrain(h, GRAPH_AXES, None, None)
        return new_feats


class NequIP(nn.Module):
    """Embedding MLP, ``n_layers`` interaction layers, readout MLP →
    per-node outputs (``node_class``) or per-graph energies
    (``energy``)."""

    def __init__(self, cfg: NequIPConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
        c = cfg.channels
        self.cfg = cfg
        self.embed = MLP([cfg.d_feat, c], **kw)
        self.layers = nn.ModuleList(NequIPLayer(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.readout = MLP([c, c, cfg.n_out], **kw)
        for name, buf in self.buffers_for(cfg, dev).items():
            self.register_buffer(name, buf, persistent=False)

    @staticmethod
    def buffers_for(cfg: NequIPConfig, device) -> dict:
        """The Gaunt tensor of each path, ``gaunt_{pi}``, in ``cfg.dtype``
        on ``device``."""
        return {f"gaunt_{pi}": torch.from_numpy(gaunt(*path)).to(
                    device=device, dtype=cfg.dtype)
                for pi, path in enumerate(cfg.paths)}

    def forward(self, node_feat: torch.Tensor, positions: torch.Tensor,
                edge_index: torch.Tensor,
                node_mask: "torch.Tensor | None" = None,
                graph_ids: "torch.Tensor | None" = None,
                n_graphs: int = 1, remat: bool = False) -> torch.Tensor:
        """``edge_index`` (2, E) int32 (src, dst), padding edges -1.

        Returns per-node outputs (N, n_out) for ``node_class`` or
        per-graph energies (n_graphs,) for ``energy``.  ``remat``
        (training, with a gradient to take) recomputes each layer in the
        backward pass, the JAX package's ``jax.checkpoint`` of
        ``apply_layer``; it changes no value.

        The layers gather source rows through a plan of the real edges'
        source ids (``segment_gather``, whose backward is B7), not by
        indexing with the clamped ids: those would send every padding
        edge's zero into node 0, a hub that PyTorch's scatter-add
        serialises (80,405 edges of a ``minibatch_lg`` batch).
        """
        cfg, c = self.cfg, self.cfg.channels
        n = node_feat.shape[0]
        src, dst = edge_index[0], edge_index[1]
        edge_mask = (src >= 0) & (dst >= 0)
        ys, rbf, emask = _edge_geometry(cfg, positions, src, dst, edge_mask)
        # The sums' and gathers' ids: padding edges dropped (their
        # messages are zero), validated and grouped by node once for
        # every sum and gather of the forward.
        seg = segment_ops.segment_plan(torch.where(edge_mask, dst, -1), n)
        src_seg = segment_ops.segment_plan(torch.where(edge_mask, src, -1), n)
        # Y_lf(r̂) · G of each path: (E, 2li+1, 2lo+1).
        filters = [torch.einsum("eb,abm->eam", ys[lf],
                                getattr(self, f"gaunt_{pi}"))
                   for pi, (_, lf, _) in enumerate(cfg.paths)]

        feats = {l: _zeros_like_rows(node_feat, (n, c, 2 * l + 1),
                                     cfg.dtype) for l in cfg.ls}
        feats[0] = self.embed(node_feat.to(cfg.dtype))[..., None]
        # The non-reentrant checkpoint also recomputes under the double
        # backward of the force term.
        for layer in self.layers:
            if remat and torch.is_grad_enabled():
                feats = checkpoint(layer, feats, filters, rbf, emask, src_seg,
                                   seg, use_reentrant=False)
            else:
                feats = layer(feats, filters, rbf, emask, src_seg, seg)

        scalars = feats[0][..., 0]                       # (N, C)
        out = self.readout(scalars)                      # (N, n_out)
        if node_mask is not None:
            out = out * node_mask[:, None]
        if cfg.readout == "node_class":
            return out
        gid = graph_ids if isinstance(graph_ids, torch.Tensor) else \
            torch.as_tensor(graph_ids, device=out.device) \
            if graph_ids is not None else _zeros_like_rows(
                node_feat, (n,), torch.int32)
        return segment_ops.segment_sum(
            out[:, :1].contiguous(), segment_ops.segment_plan(gid, n_graphs),
            n_graphs)[:, 0]


def nequip_energy_forces(model: NequIP, node_feat: torch.Tensor,
                         positions: torch.Tensor, edge_index: torch.Tensor,
                         node_mask: "torch.Tensor | None" = None,
                         graph_ids: "torch.Tensor | None" = None,
                         n_graphs: int = 1, create_graph: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-graph energies and conservative forces F = -∂E/∂positions
    (the gradient of the summed energies).  With ``create_graph`` both
    stay attached to the graph, so a loss on them can be differentiated
    with respect to the weights (``nequip_loss``); without, the energies
    are detached (serving)."""
    pos = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        e = model(node_feat, pos, edge_index, node_mask, graph_ids,
                  n_graphs, remat=create_graph)
        (grad,) = torch.autograd.grad(e.sum(), pos,
                                      create_graph=create_graph)
    return (e if create_graph else e.detach()), -grad


def nequip_loss(model: NequIP, batch: dict) -> torch.Tensor:
    """The training loss of the JAX package's ``nequip_loss``:
    ``node_class``: the NLL of ``labels`` under the per-node logits (in
    float32), averaged over ``label_mask`` (at least 1) where the batch
    has one; ``energy`` with ``forces`` in the batch: the mean squared
    energy error plus 100 × the mean squared force error, the forces
    differentiated through (a double backward); ``energy`` alone: the
    mean squared energy error."""
    args = (batch["node_feat"], batch["positions"], batch["edge_index"],
            batch.get("node_mask"))
    if model.cfg.readout == "node_class":
        logits = model(*args, remat=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.take_along_dim(logp, batch["labels"].long()[:, None],
                                    dim=-1)[:, 0]
        mask = batch.get("label_mask")
        if mask is not None:
            return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()
    graph = (batch.get("graph_ids"), batch.get("n_graphs", 1))
    if batch.get("forces") is not None:
        e, f = nequip_energy_forces(model, *args, *graph, create_graph=True)
        el = torch.mean(torch.square(e - batch["energy"]))
        fl = torch.mean(torch.square(f - batch["forces"]))
        return el + 100.0 * fl
    e = model(*args, *graph, remat=True)
    return torch.mean(torch.square(e - batch["energy"]))
