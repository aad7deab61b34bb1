"""What the kernels' entry points do on a mesh: ``DTensor`` ids checked
over every rank at once, and node rows moved between ranks around B7.

``checked_ids`` is the range check of ``DTensor`` ids (one all-reduce
of each rank's min and max, one host read), and of the decoders' ids
on one card (``id_spans`` reads several spans back at once).  Fake
ids (``is_fake``: the dry run's trace, shapes and dtypes with no
values) are read by neither: they pass unchecked, and the ids a check
returns are their cast, so a trace runs what a real run runs after
the check.  A real tensor is always checked.
``whole_rows`` and ``scatter_rows`` are the two row collectives of an
edge-sharded segment sum: every rank's rows of a ``DTensor`` gathered
whole, and every rank's sums into all rows reduce-scattered back to the
rows' ranks.  Both follow ``DTensor``'s layout of rows that do not split
evenly (``torch.chunk`` pieces, the last ones short or empty), and
each is an autograd Function whose backward is the other, so a graph
through them differentiates again (a force's gradient).
``torch.distributed.nn.functional``'s differentiable collectives are
not used: that module is deprecated (PyTorch 2.13), and under gloo its
all-gather's backward names a group's ranks by their global rank,
which fails on a mesh dim's subgroup.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..distributed import sharding as shd
from ._casting import ensure_i32_addressable, is_fake


def id_spans(*ids) -> list:
    """The (lowest, highest) element of each of ``ids`` (``None`` for an
    empty one), all read back to the host at once: over every rank of
    the mesh for ``DTensor`` ids (each rank's own, then a max over each
    mesh dim's group), so every rank sees the same.  The ids may mix
    plain tensors, the same on every rank, and ``DTensor`` ids of one
    mesh.  Fake ids have no values: if any of ``ids`` is fake, nothing
    runs and every span is ``None``."""
    if any(is_fake(x) for x in ids):
        return [None] * len(ids)
    vals, mesh = [], None
    for x in ids:
        if shd.is_dtensor(x):
            mesh, x = x.device_mesh, x.to_local()
        if x.numel():
            lo, hi = torch.aminmax(x)
            vals += [-lo.to(torch.int64), hi.to(torch.int64)]
        else:
            vals += [torch.full((), -(2 ** 62), dtype=torch.int64,
                                device=x.device)] * 2
    t = torch.stack(vals)
    if mesh is not None:
        for j in range(mesh.ndim):
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(j))
    out = t.tolist()
    return [(-out[2 * i], out[2 * i + 1]) if x.numel() else None
            for i, x in enumerate(ids)]


def checked_ids(ids, *, what: str, n_rows: int,
                allow_negative_one: bool = False,
                span: "tuple[int, int] | None" = None):
    """``ids``, a ``DTensor`` of row ids or a plain tensor, checked
    against ``[0, n_rows)`` (``[-1, n_rows)`` with
    ``allow_negative_one``) on every rank at once (``id_spans``; each
    rank raises alike) and returned as int32.  ``span`` is their
    (lowest, highest) where the caller has read it: then nothing is
    read back here.  Fake ids (``is_fake``) are cast unchecked."""
    ensure_i32_addressable(n_rows, what=f"{what}: index space")
    if span is None and ids.numel():
        span = id_spans(ids)[0]         # None for fake ids
    if span is not None:
        lo, hi = span
        if hi >= n_rows or lo < (-1 if allow_negative_one else 0):
            raise IndexError(f"{what}: ids span [{lo}, {hi}], outside "
                             f"[{-1 if allow_negative_one else 0}, "
                             f"{n_rows})")
    # Checked above: every id lies in [-1, n_rows) and n_rows <= 2³¹.
    return ids.to(torch.int32)  # lint-ok: unchecked-i32-cast


def _row_dims(placements) -> list:
    """The mesh dims that shard tensor dim 0, major first; any other
    sharding is refused."""
    dims = []
    for j, pl in enumerate(placements):
        if pl.is_shard(0):
            dims.append(j)
        elif not pl.is_replicate():
            raise ValueError(f"rows placed {tuple(placements)}: only dim 0 "
                             f"may be sharded")
    return dims


def _piece(total: int, group) -> tuple[int, int, int]:
    """(the ceil size, lo, hi) of this rank's ``torch.chunk`` piece of
    ``total`` rows split over ``group``."""
    size = -(-total // dist.get_world_size(group))
    lo = min(dist.get_rank(group) * size, total)
    return size, lo, min(lo + size, total)


def _zeros_around(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """``x`` with ``before`` zero rows put before it and ``after`` after,
    a new contiguous tensor."""
    tail = tuple(x.shape[1:])
    return torch.cat([x.new_zeros((before,) + tail), x,
                      x.new_zeros((after,) + tail)])


@functools.lru_cache(maxsize=None)
def _row_collectives():
    """The two row collectives as autograd Functions, each the other's
    backward, so that a graph through them differentiates any number of
    times (a force's gradient goes back through its own backward).  Rows
    split over a group in ``torch.chunk`` pieces; under NCCL (and on the
    dry run's fake group, which stands for it) each piece is padded to
    the ceil size for the collective and the padding cut.  A group of one
    rank runs no collective: the rows are copied."""

    class AllGatherRows(torch.autograd.Function):
        """The ``total`` rows of a group, whole, from this rank's piece
        (gloo: each rank's piece in zeros at its place, all-reduced; NCCL
        and the dry run's fake group: an all-gather)."""

        @staticmethod
        def forward(ctx, local, group, total):
            ctx.group = group
            size, lo, hi = _piece(total, group)
            n = dist.get_world_size(group)
            if n == 1:                  # one rank holds every row
                return local.clone(memory_format=torch.contiguous_format)
            if dist.get_backend(group) == "gloo":
                out = _zeros_around(local, lo, total - hi)
                dist.all_reduce(out, group=group)
                return out
            out = local.new_empty((n * size,) + tuple(local.shape[1:]))
            dist.all_gather_into_tensor(
                out, _zeros_around(local, 0, size - hi + lo), group=group)
            return out[:total]

        @staticmethod
        def backward(ctx, grad):
            return ReduceScatterRows.apply(grad, ctx.group), None, None

    class ReduceScatterRows(torch.autograd.Function):
        """The sum over a group of each rank's (R, ...) tensor, this rank
        keeping its piece of the rows (gloo has no reduce-scatter: an
        all-reduce, then the piece)."""

        @staticmethod
        def forward(ctx, x, group):
            ctx.group, ctx.total = group, x.shape[0]
            size, lo, hi = _piece(ctx.total, group)
            n = dist.get_world_size(group)
            if n == 1:                  # one rank's sums are the sums
                return x.clone(memory_format=torch.contiguous_format)
            if dist.get_backend(group) == "gloo":
                out = x.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(out, group=group)
                return out[lo:hi]
            out = x.new_empty((size,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(
                out, _zeros_around(x, 0, n * size - ctx.total), group=group)
            return out[:hi - lo]

        @staticmethod
        def backward(ctx, grad):
            return AllGatherRows.apply(grad, ctx.group, ctx.total), None

    return AllGatherRows, ReduceScatterRows


def whole_rows(x, grad_placements=None):
    """Every row of a ``DTensor`` sharded on dim 0 (or replicated), as
    this rank's plain tensor: all-gathered over each mesh dim that shards
    the rows, minor first.  Its backward reduce-scatters the rows'
    gradient back to their ranks, and differentiates again.
    ``grad_placements`` are those of the gradient of ``x``'s local
    tensor (``sharding.local_of``; by default ``x``'s own)."""
    gather, _ = _row_collectives()
    mesh = x.device_mesh
    dims = _row_dims(x.placements)
    ranges = shd.shard_ranges(x.shape[0], mesh, x.placements)
    local = shd.local_of(x, grad_placements)
    for k in reversed(range(len(dims))):
        lo, hi = ranges[k]
        local = gather.apply(local, mesh.get_group(dims[k]), hi - lo)
    return local


def scatter_rows(partial, mesh, placements, shape: tuple):
    """The sum over the ranks of each one's plain (N, ...) ``partial``,
    as a ``DTensor`` of global ``shape`` placed ``placements`` (dim 0
    sharded or replicated on each mesh dim): reduce-scattered over each
    mesh dim that shards the rows, major first (a mesh dim that
    replicates them holds whole sums already).  Its backward all-gathers,
    and differentiates again."""
    _, scatter = _row_collectives()
    for j in _row_dims(placements):
        partial = scatter.apply(partial, mesh.get_group(j))
    return shd.dtensor_of(partial, mesh, placements, shape)


def sharding_groups(x, dim: int) -> list:
    """The process groups of the mesh dims that shard ``dim`` of the
    ``DTensor`` ``x``, in mesh order (none for a plain tensor)."""
    if not shd.is_dtensor(x):
        return []
    dim = dim % x.ndim
    mesh = x.device_mesh
    return [mesh.get_group(j) for j, p in enumerate(x.placements)
            if p.is_shard(dim)]


def all_reduce_(t: torch.Tensor, groups: list, op: str = "sum"
                ) -> torch.Tensor:
    """``t`` reduced in place over each of ``groups`` in turn (``"sum"``
    or ``"max"``), untracked by autograd: the collectives inside the
    split-softmax merges (a sharded vocabulary's log-sum-exp, a sharded
    cache's decode), whose callers write their own backward.  No
    groups: ``t`` as it is."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for group in groups:
        dist.all_reduce(t, op=red, group=group)
    return t


def merge_split_softmax(m: torch.Tensor, parts: tuple, groups: list
                        ) -> tuple:
    """The split-softmax merge over ``groups``: each rank's running
    maximum ``m`` (...) over its share of the keys and its ``parts``,
    sums over the same keys scaled by ``exp(x - m)`` (a softmax's
    denominator (...), its weighted values (..., D)), rescaled to the
    maximum over all ranks and summed over them: (that maximum, the
    merged parts).  On one rank each part is multiplied by
    ``exp(0) = 1``, unchanged; with no groups nothing runs."""
    if not groups:
        return m, parts
    top = all_reduce_(m.clone(), groups, "max")
    f = torch.exp(m - top)
    out = []
    for p in parts:
        scaled = p * (f if p.ndim == f.ndim else f[..., None])
        out.append(all_reduce_(scaled, groups, "sum"))
    return top, tuple(out)
