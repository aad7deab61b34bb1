"""Shared layers: dense layers as ``nn.Module``s, and the transformer's
norms, feed-forward, rotary embeddings and embeddings as functions on
parameter dicts.

No model of either package calls ``layernorm``; it is ported with the
rest of the JAX ``layers`` module's serving functions.

The weight keeps the JAX layout ``w (d_in, d_out)`` beside the bias
``b``, so a layer computes ``x @ w + b`` exactly as the JAX package
writes it, and a carried parameter tree loads without transposes.  The
transformer's parameters are nested dicts of tensors with the JAX
package's keys (``{"scale"}``, ``{"w_gate", "w_up", "w_down"}``,
``{"table"}``), computed on by plain functions with the JAX package's
names and casts.  Initialisers draw from an explicit
``torch.Generator`` on the target device; nothing reads PyTorch's
global generator.  On the ``meta`` device they allocate and draw
nothing (shapes only, for parameter counts).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed import sharding as shd
from ..kernels._mesh import (all_reduce_, id_spans, merge_split_softmax,
                             sharding_groups)
from ..kernels.gather import ops as gather_ops


class Dense(nn.Module):
    """``x @ w + b``: ``w`` drawn normal · 1/√d_in, ``b`` zeros."""

    def __init__(self, d_in: int, d_out: int, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = torch.empty((d_in, d_out), dtype=dtype, device=device)
        self.w = nn.Parameter(w.normal_(0.0, 1.0 / math.sqrt(d_in),
                                        generator=generator))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                          device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense layers over ``dims`` with ReLU between them and no final
    activation."""

    def __init__(self, dims: "list[int] | tuple[int, ...]", *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(d_in, d_out, generator=generator, device=device,
                  dtype=dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = torch.relu(x)
        return x


# -- the transformer's layers, on parameter dicts ---------------------------

def normal(shape: tuple[int, ...], std: float, *,
           generator: "torch.Generator | None", device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """A tensor drawn normal · ``std`` in place, in ``dtype`` on
    ``device`` (left undrawn on the ``meta`` device)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, std, generator=generator)
    return t


def dense_init(d_in: int, d_out: int, scale: float | None = None,
               **kw) -> dict:
    """``{"w": (d_in, d_out)}`` drawn normal · ``scale`` (1/√d_in)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal((d_in, d_out), scale, **kw)}


def rmsnorm_init(d: int, *, device: torch.device, dtype: torch.dtype,
                 **_) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm in float32, scaled, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, *, device: torch.device, dtype: torch.dtype,
                   **_) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Layer norm in float32 (the biased variance), scaled and shifted,
    cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


def glu_ffn_init(d_model: int, d_ff: int, **kw) -> dict:
    return {
        "w_gate": dense_init(d_model, d_ff, **kw)["w"],
        "w_up": dense_init(d_model, d_ff, **kw)["w"],
        "w_down": dense_init(d_ff, d_model, scale=1.0 / math.sqrt(d_ff),
                             **kw)["w"],
    }


def glu_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (torch.nn.functional.silu(g) * u) @ params["w_down"].to(x.dtype)


def rope_freqs(positions: torch.Tensor, d: int, theta: float = 10_000.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE in float32.  positions (…,) → (…, d/2)."""
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions[..., None].float() * shd.replicate_like(inv, positions)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (…, S, H, D) with cos/sin (…, S, D/2): rotates the two halves
    of each head (not interleaved pairs), in float32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]   # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def embedding_init(vocab: int, d: int, **kw) -> dict:
    return {"table": normal((vocab, d), 0.02, **kw)}


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, (*ids.shape, D), for int32 ids already checked
    against the table (``transformer._embed`` checks a forward's ids
    once): kernel B1 on the card (``gather_ops.gather_rows_checked``),
    each rank's own vocabulary rows on a mesh."""
    return gather_ops.gather_rows_checked(params["table"], ids)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied softmax head: ``x @ table.T``.  On a table sharded on its
    rows the logits come out sharded on V, each rank its own columns."""
    return x @ params["table"].to(x.dtype).T


class _NLL(torch.autograd.Function):
    """``logsumexp(logits) - logits[label]`` per row, whose backward
    writes ``softmax - onehot`` straight into one tensor of the logits'
    shape: autograd through ``logsumexp`` and ``take_along_dim`` would
    hold two more (two-tower's in-batch logits at 65,536 rows are
    17.2 GB each).

    The logits may be this rank's columns ``[lo, lo + V')`` of a
    vocabulary split over ``groups`` (the ranks that hold the other
    columns): the row's maximum is all-reduced (MAX), then its sum of
    ``exp(x - max)`` (SUM), and the gold logit is the owner's (SUM of
    it and the others' zeros); the backward stays on the rank's own
    columns.  With no groups (one card) the same operations run with
    nothing to reduce, so one rank of a mesh equals one card bit for
    bit."""

    @staticmethod
    def forward(ctx, logits, labels, lo, groups):
        m = all_reduce_(logits.amax(dim=-1), groups, "max")
        s = all_reduce_(torch.sub(logits, m[..., None]).exp_().sum(dim=-1),
                        groups, "sum")
        hit = (labels >= lo) & (labels < lo + logits.shape[-1])
        col = torch.where(hit, labels - lo, 0)
        gold = torch.where(hit, torch.take_along_dim(
            logits, col[..., None], dim=-1)[..., 0], 0.0)
        logz = m + torch.log(s)
        ctx.save_for_backward(logits, logz, col, hit)
        return logz - all_reduce_(gold, groups, "sum")

    @staticmethod
    def backward(ctx, grad_nll):
        logits, logz, col, hit = ctx.saved_tensors
        grad = torch.sub(logits, logz[..., None]).exp_()
        grad.mul_(grad_nll[..., None])
        grad.scatter_add_(-1, col[..., None],
                          torch.where(hit, -grad_nll, 0.0)[..., None])
        return grad, None, None, None


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _NLL.apply(logits, labels, 0, [])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: "torch.Tensor | None" = None,
                  label_span: "tuple[int, int] | None" = None
                  ) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``
    (…, V), in float32: ``logsumexp`` minus the label's logit; with
    ``mask``, the masked sum over the mask's sum (at least 1).  A label
    outside [0, V) raises ``IndexError``: ``label_span`` is the labels'
    (lowest, highest) where the caller has read it, else it is read
    here (one read back from the card).  On a mesh each rank works on
    its own rows and vocabulary columns (``_vocab_parallel_nll``)."""
    v = logits.shape[-1]
    span = label_span
    if span is None and labels.numel():
        span = id_spans(labels)[0]      # None for fake labels
    if span is not None:
        lo, hi = span
        if lo < 0 or hi >= v:
            raise IndexError(f"cross_entropy: labels span [{lo}, {hi}], "
                             f"outside [0, {v})")
    logits, labels = logits.float(), labels.long()
    if shd.is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        nll = _nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _vocab_parallel_nll(logits, labels):
    """``_NLL`` of ``DTensor`` logits (…, V) on each rank's own block: a
    partial sum reduced first, then each rank its own rows and, where V
    is sharded (an LM's head), its own V / model columns, the row
    statistics merged over the ranks that split V; the NLL (…) placed
    as the rows."""
    from torch.distributed.tensor import Replicate

    mesh = logits.device_mesh
    last = logits.ndim - 1
    want = [Replicate() if p.is_partial() else p for p in logits.placements]
    if tuple(want) != tuple(logits.placements):
        logits = logits.redistribute(mesh, want)
    # Where its rows lie: every placement but V's.
    rows = [Replicate() if p.is_shard(last) else p for p in want]
    labels = shd.replicate_like(labels, logits)
    if tuple(labels.placements) != tuple(rows):
        labels = labels.redistribute(mesh, rows)
    nll = _NLL.apply(shd.local_of(logits), labels.to_local(),
                     shd.local_range(logits, last)[0],
                     sharding_groups(logits, last))
    return shd.dtensor_of(nll, mesh, rows, tuple(logits.shape[:-1]))


class _TiedChunkedNLL(torch.autograd.Function):
    """Per-row ``logsumexp(h @ table.T) - (h @ table.T)[label]`` over
    vocabulary chunks, in float32 (float64 for float64 inputs), never
    holding more than one (rows, chunk) tile of logits.

    The forward runs the online logsumexp chunk by chunk and saves only
    ``h``, ``table``, the labels and each row's logsumexp (``m + log s``
    of the running maximum ``m`` and sum ``s``).  The backward walks the
    chunks again: it recomputes each chunk's logits, forms ``softmax -
    onehot`` scaled by the row's incoming gradient, and adds its share
    to ``dh`` and to that chunk's rows of ``dtable``.  Autograd through
    the loop would keep every chunk's logits, the whole (rows, V) tensor
    this exists to avoid; the JAX package's ``jax.checkpoint`` inside its
    scan is the same recomputation.  Columns past V (a last chunk that
    is not full) are ``-inf``.

    ``table`` may be this rank's rows ``[lo, lo + V')`` of a vocabulary
    split over ``groups``: the chunks walk those rows only, each rank's
    ``(m, s, gold)`` is merged over the groups (``merge_split_softmax``;
    the gold logit is its owner's), and the backward returns this
    rank's share of ``dh`` (the callers sum it over the groups) and its
    own rows of ``dtable``."""

    @staticmethod
    def forward(ctx, h, table, labels, chunk, lo, groups):
        acc = torch.promote_types(h.dtype, torch.float32)
        h2 = h.to(acc)
        v = table.shape[0]
        rows = h2.shape[0]
        labels = labels - lo
        m = torch.full((rows,), -torch.inf, dtype=acc, device=h.device)
        s = torch.zeros((rows,), dtype=acc, device=h.device)
        gold = torch.zeros((rows,), dtype=acc, device=h.device)
        for start in range(0, v, chunk):
            stop = min(start + chunk, v)
            logits = h2 @ table[start:stop].to(acc).T        # (rows, c)
            hit = (labels >= start) & (labels < stop)
            col = torch.where(hit, labels - start, 0).long()
            gold = gold + torch.where(
                hit, logits.gather(1, col[:, None])[:, 0], 0.0)
            m2 = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - m2) + logits.sub_(
                m2[:, None]).exp_().sum(dim=-1)
            m = m2
        if groups:
            m, (s,) = merge_split_softmax(m, (s,), groups)
            gold = all_reduce_(gold, groups, "sum")
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        ctx.save_for_backward(h, table, labels, lse)
        ctx.chunk = chunk
        return lse - gold

    @staticmethod
    def backward(ctx, grad_nll):
        h, table, labels, lse = ctx.saved_tensors
        acc = lse.dtype
        h2 = h.to(acc)
        g = grad_nll.to(acc)
        dh = torch.zeros_like(h2)
        dtable = torch.zeros(table.shape, dtype=acc, device=table.device)
        for start in range(0, table.shape[0], ctx.chunk):
            stop = min(start + ctx.chunk, table.shape[0])
            tb = table[start:stop].to(acc)
            p = torch.sub(h2 @ tb.T, lse[:, None]).exp_()   # softmax tile
            p.mul_(g[:, None])
            hit = (labels >= start) & (labels < stop)
            col = torch.where(hit, labels - start, 0).long()
            p.scatter_add_(1, col[:, None],
                           torch.where(hit, -g, 0.0)[:, None])
            dh.addmm_(p, tb)
            dtable[start:stop] = p.T @ h2
        return (dh.to(h.dtype), dtable.to(table.dtype), None, None, None,
                None)


def cross_entropy_tied_chunked(h: torch.Tensor, table: torch.Tensor,
                               labels: torch.Tensor,
                               weights: "torch.Tensor | None" = None,
                               chunk: int = 16_384) -> torch.Tensor:
    """CE of ``labels`` under the tied logits ``h @ table.T`` without
    materialising (…, V): h (…, D), table (V, D), labels (…) int.  The
    mean NLL, or with ``weights`` (…) the weighted sum over the weights'
    sum (at least 1).  Peak memory is one (rows, chunk) tile in the
    forward and in the backward (``_TiedChunkedNLL``); V need not be a
    multiple of ``chunk``.  On a mesh (``DTensor`` ``h`` and ``table``)
    each rank walks its own vocabulary rows (``_tied_chunked_mesh``)."""
    d = h.shape[-1]
    if shd.is_dtensor(table):
        nll = _tied_chunked_mesh(h, table, labels, chunk)
    else:
        nll = _TiedChunkedNLL.apply(h.reshape(-1, d), table,
                                    labels.reshape(-1), chunk, 0, [])
    if weights is not None:
        w = weights.reshape(nll.shape).to(nll.dtype)
        return torch.sum(nll * w) / torch.clamp(w.sum(), min=1.0)
    return nll.mean()


def _tied_chunked_mesh(h, table, labels, chunk: int):
    """``_TiedChunkedNLL`` of a ``DTensor`` ``h`` (R, …, D) and a table
    sharded on its rows: each rank the chunks of its own V / model rows
    on its own rows of ``h``, the row statistics merged over the ranks
    that split V.  ``dh`` comes back a partial sum over those ranks
    (summed where ``h``'s gradient meets its placement) and ``dtable``
    on the rank's own rows, a partial sum over the ranks that split
    ``h``'s rows until the train step reduces it.  The NLL (R, …) is
    placed as ``h``'s rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    h = shd.replicate_like(h, table)
    vocab = [p.is_shard(0) for p in table.placements]
    rows = [Shard(0) if p.is_shard(0) and not v else Replicate()
            for p, v in zip(h.placements, vocab)]
    if tuple(h.placements) != tuple(rows):
        h = h.redistribute(mesh, rows)
    want_t = [Shard(0) if v else Replicate() for v in vocab]
    if tuple(table.placements) != tuple(want_t):
        table = table.redistribute(mesh, want_t)
    labels = shd.replicate_like(labels, h)
    if tuple(labels.placements) != tuple(rows):
        labels = labels.redistribute(mesh, rows)
    h_local = shd.local_of(h, [Partial() if v else p
                               for p, v in zip(rows, vocab)])
    t_local = shd.local_of(table, [Partial() if r.is_shard() else p
                                   for p, r in zip(want_t, rows)])
    d = h.shape[-1]
    nll = _TiedChunkedNLL.apply(h_local.reshape(-1, d), t_local,
                                labels.to_local().reshape(-1), chunk,
                                shd.local_range(table, 0)[0],
                                sharding_groups(table, 0))
    return shd.dtensor_of(nll.reshape(labels.to_local().shape), mesh, rows,
                          tuple(labels.shape))
