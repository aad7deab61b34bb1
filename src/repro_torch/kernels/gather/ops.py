"""Public entry points for extraction gathers.

The tensor's device decides the path: a CUDA tensor launches the CUDA
kernel (``kernel``), a CPU tensor takes the plain PyTorch version
(``ref``).  There is no fallback between them: a failed build or launch
raises.  ``use_pallas``/``interpret`` of ``gather_rows`` and
``gather_plan_runs`` keep the JAX package's signatures for parity and
are ignored — on the port the device decides.

``gather_rows`` (B1) and ``gather_rows_bag`` (B6) are the custom ops
``repro_torch::gather_rows`` and ``repro_torch::gather_rows_bag``: the
kernel on the card, ``ref`` on the CPU, a fake for ``meta`` and fake
tensors, and differentiable with respect to the table.  Their backward
is ``ref.gather_rows_backward`` / ``ref.gather_rows_bag_backward`` as
ops of their own (plain PyTorch on every device: the JAX package takes
these gradients with XLA's scatter-add, not with a Pallas kernel).

On a ``DTensor`` table (a model on a mesh) the work stays on each
rank's own shard: ``sharded_rows`` hands each rank's kernel its own rows
of a table sharded on them (``recsys_rules``), the ids of other ranks'
rows as -1 (B6 drops them as padding; B1 reads a zero row), and sums the
ranks' results; a replicated table keeps the ids' placement.  No rank
holds or gathers another's rows.  ``DTensor`` ids are checked once for
all ranks (``kernels._mesh.checked_ids``).

The host arrays a launch reads (a plan's runs; a window's union and
positions) are validated and cast on the host, then reach the card
through one pinned buffer and one non-blocking copy
(``_device.upload``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import upload
from ...distributed import sharding as shd
from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from .._casting import I32_LIMIT, checked_cast_i32
from .._mesh import checked_ids
from . import kernel, ref

# The JAX package's burst chunk width in elements (its DMA block):
# ``chunk_runs``'s default, and accepted and ignored by
# ``gather_plan_runs``, which copies runs whole.
BURST_BLOCK = 128
# The longest run B2 is handed: its lengths are int32.
I32_MAX = I32_LIMIT - 1


def _route(t: torch.Tensor):
    """``kernel`` for a CUDA tensor, ``ref`` for a CPU tensor; any other
    device raises (the ops' fakes serve fake tensors, which report the
    device they stand for, and ``meta`` tensors given to an op
    directly)."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return ref
    raise ValueError(f"no gather path for a tensor on {t.device}")


def _index_tensor(indices, device: torch.device, *, what: str,
                  n_elements: int,
                  allow_negative_one: bool = False) -> torch.Tensor:
    """Validate and cast offsets to int32 (host-side for numpy input),
    then place them beside the data."""
    idx = checked_cast_i32(indices, what=what, n_elements=n_elements,
                           allow_negative_one=allow_negative_one)
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(idx)
    return idx.to(device)


# -- B1 and B6 as custom ops --------------------------------------------------
# Each op runs its kernel on a CUDA tensor (``kernel``, counted in
# ``LAUNCHES``) and its plain version on a CPU tensor (``ref``); its fake
# gives the output's shape and dtype on ``meta`` and fake tensors, and its
# backward is the plain PyTorch gradient of ``ref`` as an op of its own.
# The bodies look ``kernel.<name>`` up at each call, so a caller that
# swaps the module's function (a recorder, a plain stand-in) is obeyed.
@torch.library.custom_op("repro_torch::gather_rows", mutates_args=(),
                         device_types="cuda")
def gather_rows_op(table: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """B1: ``table[indices]`` for an (N, D) table and (M,) int32 ids in
    [0, N), already checked."""
    return kernel.gather_rows(table, indices)


@gather_rows_op.register_kernel("cpu")
def _(table, indices):
    return ref.gather_rows(table, indices)


@gather_rows_op.register_fake
def _(table, indices):
    return table.new_empty((indices.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::gather_rows_backward",
                         mutates_args=())
def gather_rows_backward_op(grad_out: torch.Tensor, indices: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """B1's gradient with respect to its table: ``ref.gather_rows_backward``
    on every device."""
    return ref.gather_rows_backward(grad_out, indices, n_rows)


@gather_rows_backward_op.register_fake
def _(grad_out, indices, n_rows):
    return grad_out.new_empty((n_rows, grad_out.shape[1]))


@torch.library.custom_op("repro_torch::gather_rows_bag", mutates_args=(),
                         device_types="cuda")
def gather_rows_bag_op(table: torch.Tensor,
                       bags: torch.Tensor) -> torch.Tensor:
    """B6: bag sums of an (N, D) table over (B, L) int32 bags in [-1, N),
    already checked."""
    return kernel.gather_rows_bag(table, bags)


@gather_rows_bag_op.register_kernel("cpu")
def _(table, bags):
    return ref.gather_rows_bag(table, bags)


@gather_rows_bag_op.register_fake
def _(table, bags):
    return table.new_empty((bags.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::gather_rows_bag_backward",
                         mutates_args=())
def gather_rows_bag_backward_op(grad_out: torch.Tensor, bags: torch.Tensor,
                                n_rows: int) -> torch.Tensor:
    """B6's gradient with respect to its table:
    ``ref.gather_rows_bag_backward`` on every device."""
    return ref.gather_rows_bag_backward(grad_out, bags, n_rows)


@gather_rows_bag_backward_op.register_fake
def _(grad_out, bags, n_rows):
    # The op's rows of a buffer with its spare row, as ``ref`` returns
    # them: the dry run's trace counts the buffer's bytes.
    return grad_out.new_empty((n_rows + 1, grad_out.shape[1]))[:n_rows]


def _save_ids(ctx, inputs, output):
    table, ids = inputs
    ctx.save_for_backward(ids)
    ctx.n_rows = table.shape[0]


def _gather_rows_grad(ctx, grad_out):
    (ids,) = ctx.saved_tensors
    return gather_rows_backward_op(grad_out, ids, ctx.n_rows), None


def _gather_rows_bag_grad(ctx, grad_out):
    (bags,) = ctx.saved_tensors
    return gather_rows_bag_backward_op(grad_out, bags, ctx.n_rows), None


gather_rows_op.register_autograd(_gather_rows_grad, setup_context=_save_ids)
gather_rows_bag_op.register_autograd(_gather_rows_bag_grad,
                                     setup_context=_save_ids)


def sharded_rows(table, ids, row_dim: int, local_fn):
    """A lookup of a ``DTensor`` table at ``ids`` run on each rank's own
    rows, with no rank gathering another's: ``local_fn(local_table,
    local_ids)`` on this rank's shard of the table (rows [lo, hi) of dim
    ``row_dim``) and its ids, each id outside [lo, hi) given as -1 and
    the others as ``id - lo``.  The table is sharded on ``row_dim`` or
    replicated on each mesh dim.  On a dim that shards its rows, the ids
    are first made whole there (an all-gather of ids, never of rows) and
    the local results, zero where an id is not this rank's, are summed
    over it (``Partial``); on a dim that replicates it, the ids keep
    their placement and so does the result.  The result (its dim 0
    follows the ids' dim 0) ends placed as the ids were.  The table's
    gradient comes back on its own rows, a partial sum over the ranks
    that split the batch until the train step reduces it
    (``train_state.value_and_grad``).  ``ids`` may be a plain tensor,
    the same on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    want, out_p, grad_p = [], [], []
    for tp, ip in zip(table.placements, ids.placements):
        if tp.is_shard(row_dim):
            want.append(Replicate())
            out_p.append(Partial())
            grad_p.append(tp)
        elif tp.is_replicate() and not ip.is_partial():
            want.append(ip)
            out_p.append(ip)
            grad_p.append(Partial() if ip.is_shard() else Replicate())
        else:
            raise ValueError(f"sharded_rows: a table placed {tp} with ids "
                             f"placed {ip}")
    whole = ids.redistribute(mesh, want) if tuple(want) != \
        tuple(ids.placements) else ids
    lo, hi = shd.local_range(table, row_dim)
    mine = whole.to_local()
    local_ids = torch.where((mine >= lo) & (mine < hi), mine - lo, -1)
    out = local_fn(shd.local_of(table, grad_p), local_ids)
    out = shd.dtensor_of(out, mesh, out_p,
                         (ids.shape[0],) + tuple(out.shape[1:]))
    return out.redistribute(mesh, ids.placements)


def _local_gather_rows(table: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """B1 on this rank's rows over ids of any shape: a -1 id reads a zero
    row."""
    flat = ids.reshape(-1)
    rows = gather_rows_op(table, flat.clamp(min=0))
    rows = torch.where((flat >= 0)[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows.reshape(*ids.shape, table.shape[1])


def gather_rows(table: torch.Tensor, indices, use_pallas: bool = False,
                interpret: bool = True) -> torch.Tensor:
    """``table[indices]`` for an (N, D) table and ids of any shape,
    (*indices.shape, D): kernel B1 over the flattened ids on the card
    (one launch).  The ids are checked against the table first (once
    for all ranks on a mesh), then read by ``gather_rows_checked``."""
    _route(table)           # a table on any other device raises
    what, n = "gather_rows indices", table.shape[0]
    if shd.is_dtensor(indices):
        idx = checked_ids(indices, what=what, n_rows=n)
    else:
        idx = _index_tensor(indices, table.device, what=what, n_elements=n)
    return gather_rows_checked(table, idx)


def gather_rows_checked(table: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """``gather_rows`` on int32 ids of any shape already on the table's
    device and known to lie in [0, N): no check, no host read.  A
    ``DTensor`` table is read through ``sharded_rows`` (each rank B1 on
    its own rows, other ranks' ids read as zero rows, the ranks' results
    summed)."""
    if shd.is_dtensor(table):
        return sharded_rows(table, ids, 0, _local_gather_rows)
    return gather_rows_op(table, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def gather_plan_rows(flat: torch.Tensor, offsets, row: int,
                     use_pallas: bool = False) -> torch.Tensor:
    """Extraction-plan adapter: gather ``row``-element blocks of a flat
    (n,) payload, one B1 launch on the card.  ``offsets`` (numpy or a
    tensor) are block-aligned element offsets of an extraction plan
    (``run_starts`` coalesced to ``row``-element blocks); the payload's
    tail past its last whole block is not addressable.  Returns
    (len(offsets), row)."""
    n = flat.shape[0] // row
    return gather_rows(flat[: n * row].view(n, row), offsets // row)


def gather_rows_bag(table: torch.Tensor, bags) -> torch.Tensor:
    """Fused EmbeddingBag(sum) over an (N, D) table: ``out[b] =
    sum_l table[bags[b, l]]`` for (B, L) bags padded with -1 (the only
    negative value allowed); kernel B6 on the card."""
    _route(table)           # a table on any other device raises
    if shd.is_dtensor(bags):
        return gather_rows_bag_checked(table, checked_ids(
            bags, what="gather_rows_bag bags", n_rows=table.shape[0],
            allow_negative_one=True))
    idx = _index_tensor(bags, table.device, what="gather_rows_bag bags",
                        n_elements=table.shape[0], allow_negative_one=True)
    return gather_rows_bag_checked(table, idx)


def gather_rows_bag_checked(table: torch.Tensor,
                            bags: torch.Tensor) -> torch.Tensor:
    """``gather_rows_bag`` on (B, L) int32 bags already on the table's
    device and known to lie in [-1, N): no check, no host read.  A
    ``DTensor`` table is summed by ``sharded_rows`` (B6 drops the ids of
    other ranks' rows as padding)."""
    if shd.is_dtensor(table):
        return sharded_rows(table, bags, 0, gather_rows_bag_op)
    return gather_rows_bag_op(table, bags)


def chunk_runs(run_starts: np.ndarray, run_lengths: np.ndarray,
               block: int = BURST_BLOCK
               ) -> tuple[np.ndarray, np.ndarray]:
    """Split coalesced plan runs into ≤``block``-element copy chunks.

    Pure numpy (host side — plan post-processing, not kernel work).
    Returns (chunk_starts (C,) int64, gather_idx (N,) int64): chunk c
    covers elements [chunk_starts[c], chunk_starts[c] + block) of the
    payload, and ``gather_idx`` compacts the (C·block,) chunk lattice
    back to the plan's N points in offset order.
    """
    starts = np.asarray(run_starts, np.int64)
    lens = np.asarray(run_lengths, np.int64)
    if starts.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    n_chunks = -(-lens // block)
    tot = int(n_chunks.sum())
    ends = np.cumsum(n_chunks)
    ordinal = np.arange(tot) - np.repeat(ends - n_chunks, n_chunks)
    chunk_starts = np.repeat(starts, n_chunks) + ordinal * block
    chunk_lens = np.minimum(block, np.repeat(lens, n_chunks)
                            - ordinal * block)
    cends = np.cumsum(chunk_lens)
    n = int(cends[-1])
    ramp = np.arange(n) - np.repeat(cends - chunk_lens, chunk_lens)
    gather_idx = np.repeat(np.arange(tot) * block, chunk_lens) + ramp
    return chunk_starts, gather_idx


def split_long_runs(starts: np.ndarray, lengths: np.ndarray,
                    most: int = I32_MAX) -> tuple[np.ndarray, np.ndarray]:
    """The runs (int64) with each run longer than ``most`` elements cut
    into pieces of ``most`` (the last one shorter), in order: the same
    elements in the same order, so the prefix of the lengths still puts
    each element at its point.  Runs that fit come back as they were."""
    long = lengths > most
    pieces = np.where(long, -(-lengths // most), 1)
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    k = np.arange(int(pieces.sum())) - first
    run_len = np.repeat(lengths, pieces)
    return (np.repeat(starts, pieces) + k * most,
            np.minimum(run_len - k * most, most))


def plan_run_inputs(flat: torch.Tensor, run_starts, run_lengths) -> tuple:
    """What ``gather_plan_runs`` hands its kernel for a plan's runs: the
    starts (int32, checked against the payload as the JAX package checks
    its chunk starts; an empty run's start is not read and is passed as
    0), the lengths (int32, checked: a run longer than 2³¹ − 1 elements
    is first cut into pieces that fit, ``split_long_runs``) and their
    exclusive prefix (int64, on the host over the runs: O(runs), not
    O(points)), all on the payload's device from one upload, and the
    number of points.  A run that ends past the payload raises."""
    n = flat.shape[0]
    lengths = np.asarray(run_lengths, dtype=np.int64).reshape(-1)
    starts = np.asarray(run_starts).reshape(-1)
    if starts.shape != lengths.shape:
        raise ValueError(f"{starts.size} run starts for {lengths.size} "
                         f"run lengths")
    if lengths.size and lengths.min() < 0:
        raise ValueError(f"negative run length {lengths.min()}")
    starts = checked_cast_i32(np.where(lengths > 0, starts, 0),
                              what="burst gather run starts", n_elements=n)
    ends = starts + lengths
    if ends.size and ends.max() > n:
        raise IndexError(f"burst gather: a run ends at {ends.max()}, past "
                         f"the payload's {n} elements")
    if lengths.size and lengths.max() > I32_MAX:
        # Each piece starts inside the payload, so its start fits too.
        starts, lengths = split_long_runs(starts.astype(np.int64), lengths)
        starts = checked_cast_i32(starts, what="burst gather run starts",
                                  n_elements=n)
    offsets = np.zeros(lengths.size + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    lengths = checked_cast_i32(lengths, what="burst gather run lengths")
    return (*upload(flat.device, starts, lengths, offsets),
            int(offsets[-1]))


def gather_plan_runs(flat: torch.Tensor, run_starts: np.ndarray,
                     run_lengths: np.ndarray, block: int = BURST_BLOCK,
                     use_pallas: bool = False,
                     interpret: bool = True) -> torch.Tensor:
    """Run-length-aware gather of an extraction plan: each coalesced run
    of the flat (n,) payload copied straight into the plan's points, one
    launch of kernel B2 on the card.  Byte-equal to
    ``flat[plan.offsets]``.

    ``block`` is the JAX package's DMA chunk width, accepted and ignored:
    no chunk lattice is built, so unlike the JAX function this one does
    not raise when that lattice would pass 2³¹ elements, only where a run
    start or the payload does.
    """
    route = _route(flat)
    return route.gather_plan_runs(flat, *plan_run_inputs(flat, run_starts,
                                                         run_lengths))


def union_slice_inputs(flat: torch.Tensor, union, positions) -> tuple:
    """What ``gather_union_slices`` hands its kernel: the union's offsets
    (int32, checked against the payload) and the positions (int32,
    checked against the union), on the payload's device from one
    upload."""
    union = checked_cast_i32(np.asarray(union), what="union read offsets",
                             n_elements=flat.shape[0])
    positions = checked_cast_i32(np.asarray(positions),
                                 what="union slice positions",
                                 n_elements=union.size)
    return tuple(upload(flat.device, union, positions))


def gather_union_slices(flat: torch.Tensor, union,
                        positions) -> torch.Tensor:
    """``flat[union][positions]`` for a serving window: the sorted union of
    its plans' offsets and, concatenated, each plan's positions in it
    (host arrays).  One launch on the card, the union never
    materialised."""
    route = _route(flat)
    return route.gather_union_slices(flat, *union_slice_inputs(
        flat, union, positions))
