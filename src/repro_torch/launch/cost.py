"""The dry run's trace: a cell's ``fn`` run once on fake tensors, as
rank 0 of a fake process group of the mesh's size, with its cost,
collectives and memory read off the ops it dispatches.

The JAX dry run reads these from the compiled XLA program of each cell.
The port compiles no whole program, so it traces: ``trace`` runs a
function under ``torch._subclasses.FakeTensorMode`` (tensors with a
shape, a dtype and a device and no values, so nothing is allocated and
no kernel runs) and under ``CostMode``, a dispatch mode that sees every
op rank 0 runs on its own shards.  A ``DTensor`` op is passed on to
``DTensor`` (``NotImplemented``), which runs it as local ops and
collectives that the mode then sees, so nothing is counted twice: the
counts are per device, as XLA's are after SPMD partitioning.

``CostMode`` counts, over rank 0's local ops:
- **FLOPs**: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``; an op without one that decomposes is counted
  through its decomposition, as ``FlopCounterMode`` does), and for the
  port's custom ops one add per gathered element of B6
  (``repro_torch::gather_rows_bag``) and of its backward, E × D adds
  for B7 (``repro_torch::segment_sum``) and for its gather, one add per
  element of B1's backward and 0 for B1.  Elementwise ops have no
  formula, so their FLOPs are not counted; XLA's ``cost_analysis``
  counts them, so the two counts are not comparable.
- **bytes accessed**: the bytes of every tensor input and output of
  every op that moves data (views and allocations without a write
  excluded), custom ops and collectives included.
- **collectives**: the JAX dry run's five kinds, each ``{"bytes",
  "count"}``, and ``total_bytes``; bytes are each collective's result
  bytes on the device (``launch.dryrun.collective_bytes``'s rule).  The
  mode sees DTensor's redistributions as ``_c10d_functional`` ops and
  the ``torch.distributed`` calls of ``kernels._mesh`` and
  ``distributed.compression`` as ``c10d`` ops; a collective of any
  other name raises.
- **memory**: the live bytes of every storage an op creates, from its
  creation to the storage's end (a ``weakref.finalize``), on top of the
  arguments' storages; ``peak_bytes`` is their maximum.  The cyclic
  garbage collector is off during a trace, so storages end where their
  last reference goes, the same in every run.

The same mode runs over real tensors (the tests hold a fake trace
against a real run of the same cell on a one-rank mesh).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import math
import time
import weakref
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DEVICE = torch.ops.prim.device.default
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# Each collective op by schema name: its kind, and where its result
# lies (the op's output for a functional collective, its first
# argument, the buffer it writes, for a ``c10d`` one).
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
}
# Ops of the two namespaces that move no data of their own.
_COLLECTIVE_WAITS = {"_c10d_functional::wait_tensor", "c10d::barrier",
                     "c10d::monitored_barrier_"}
# Creations that write nothing, and pure metadata queries.
_NO_DATA = {"aten::empty", "aten::empty_strided", "aten::new_empty",
            "aten::new_empty_strided", "aten::empty_like",
            "aten::size", "aten::stride", "aten::numel",
            "aten::dim", "aten::is_contiguous", "aten::storage_offset",
            "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
            "aten::sym_storage_offset", "prim::layout"}


def _bookkeeping() -> list:
    """(owner, name, whether to leave the fake mode) of each function of
    ``DTensor`` that works out placements by running ops, which no rank
    runs: the sharding propagation's run of an op on global-shape fake
    tensors, and a strided shard's size and offsets, read from a real
    index tensor.  Those present in this PyTorch; the propagation must
    be."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    out = [(ShardingPropagator, "_propagate_tensor_meta_non_cached", False)]
    strided = getattr(pt, "_StridedShard", None)
    for name in ("local_shard_size_and_offset",
                 "_local_shard_size_and_offset"):
        if strided is not None and name in vars(strided):
            out.append((strided, name, True))
    return out


def _card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """``DTensor``'s shard-to-shard move as it runs on the card: one
    ``_dtensor::shard_dim_alltoall``.  A mesh on "cpu" (the trace's)
    would take gloo's stand-in, an all-gather and a chunk."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# -- FLOP formulas of the port's custom ops -------------------------------
# As ``torch.utils.flop_counter``'s own: of the inputs' and the output's
# shapes (``shape_wrapper`` hands them over).
def _bag_adds(table, bags, *_, out_shape=None, **__) -> int:
    """B6: one add per gathered element, (B, L) slots × D."""
    return math.prod(bags) * table[1]


def _bag_backward_adds(grad_out, bags, *_, out_shape=None, **__) -> int:
    """B6's backward: one add per scattered element, (B, L) slots × D."""
    return math.prod(bags) * grad_out[1]


def _rows_backward_adds(grad_out, indices, *_, out_shape=None,
                        **__) -> int:
    """B1's backward: one add per scattered element, M × D."""
    return math.prod(grad_out)


def _segment_adds(x, ids, *_, out_shape=None, **__) -> int:
    """B7 and its gather: E × D adds."""
    return ids[0] * (out_shape[1] if len(out_shape) > 1 else 1)


def _no_flops(*_, **__) -> int:
    return 0


def custom_formulas() -> dict:
    """The FLOP formulas of the port's custom ops, by op packet, in the
    form of ``FlopCounterMode``'s ``custom_mapping``."""
    # Importing the entry points registers the custom ops.
    from ..kernels.gather import ops as _gops  # noqa: F401
    from ..kernels.segment import ops as _sops  # noqa: F401

    ops = torch.ops.repro_torch
    return {ops.gather_rows: _no_flops,
            ops.gather_rows_backward: _rows_backward_adds,
            ops.gather_rows_bag: _bag_adds,
            ops.gather_rows_bag_backward: _bag_backward_adds,
            ops.segment_sum: _segment_adds,
            ops.segment_gather: _segment_adds}


def formulas() -> dict:
    """``FlopCounterMode``'s formulas by op packet, and the custom ops'
    (``custom_formulas``), each taking the op's tensors."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper

    return {**flop_registry, **{k: shape_wrapper(f) for k, f in
                                custom_formulas().items()}}


class CostMode(TorchDispatchMode):
    """Counts rank 0's local ops while it is entered: ``flops``,
    ``bytes_accessed``, ``collectives`` (by kind) and the live and peak
    bytes of the storages the ops create on top of those ``track``ed
    before (``live_bytes``, ``peak_bytes``).  ``DTensor`` ops are left
    to ``DTensor``, whose local ops come back here."""

    def __init__(self) -> None:
        from torch.distributed.tensor import DTensor

        super().__init__()
        self._dtensor = DTensor
        self.registry = formulas()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"bytes": 0, "count": 0}
                            for k in COLLECTIVES}
        self.collective_log: list = []  # (op, kind, result bytes) each
        self.live_bytes = 0
        self.peak_bytes = 0
        self._sizes: dict = {}      # storage key → its bytes, while live
        self.paused = 0             # > 0 inside DTensor's propagation

    @contextlib.contextmanager
    def entered(self):
        """The mode entered, and paused while ``DTensor`` works out
        placements (``_bookkeeping``): its sharding propagation runs each
        new op once on global-shape fake tensors to learn the output's
        shape, and a strided shard's offsets are read from an index
        tensor.  No rank runs those ops; the offsets' tensor is made
        real (outside the fake mode), since a fake one has no values to
        read.  Each redistribution plan is kept for the trace, and over
        a fake process group, which stands for the card's, a
        shard-to-shard move on a mesh on "cpu" runs as on the card
        (``_card_alltoall``)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        patched = []

        def wrap(real, unfake: bool):
            @functools.wraps(real)
            def quiet(*args, **kwargs):
                self.paused += 1
                try:
                    with (unset_fake_temporarily() if unfake
                          else contextlib.nullcontext()):
                        return real(*args, **kwargs)
                finally:
                    self.paused -= 1
            return quiet

        for owner, name, unfake in _bookkeeping():
            real = inspect.getattr_static(owner, name)
            fn = real.__func__ if isinstance(real, staticmethod) else real
            quiet = wrap(fn, unfake)
            setattr(owner, name, staticmethod(quiet)
                    if isinstance(real, staticmethod) else quiet)
            patched.append((owner, name, real))
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor import placement_types as pt

        name = "_gen_transform_infos_non_cached"
        if hasattr(_redistribute, name):
            # Under a fake mode ``DTensor`` takes itself to be tracing a
            # graph, whose shapes may be symbolic, and plans every
            # redistribution it prices anew (tens of thousands of plans
            # for one step on a 3-D mesh); a fake trace's shapes are
            # fixed, so each plan is kept, as a real run keeps it.
            real = getattr(_redistribute, name)
            patched.append((_redistribute, name, real))
            setattr(_redistribute, name, functools.lru_cache(None)(real))
        if dist.is_initialized() and dist.get_backend() == "fake" and \
                hasattr(pt, "shard_dim_alltoall"):
            patched.append((pt, "shard_dim_alltoall", pt.shard_dim_alltoall))
            pt.shard_dim_alltoall = _card_alltoall
        try:
            with self:
                yield self
        finally:
            for owner, name, real in reversed(patched):
                setattr(owner, name, real)

    # -- memory ---------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now to its end, once."""
        s = t.untyped_storage()
        key = s._cdata
        if key in self._sizes:
            return
        n = s.nbytes()
        self._sizes[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._sizes.pop(key)

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:             # a metadata query, most of all
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self.paused:
            return func(*args, **kwargs)
        name = func.name().split(".")[0]
        packet = func._overloadpacket
        if packet not in self.registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        self._count_collective(name, args, out)
        if not func.is_view and name not in _NO_DATA | _COLLECTIVE_WAITS:
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs))))
            self.bytes_accessed += sum(map(_nbytes, _tensors(out)))
        for t in _tensors(out):
            self.track(t)
        return out

    def _count_collective(self, name: str, args, out) -> None:
        ns = name.split("::")[0]
        if ns not in ("c10d", "_c10d_functional") and \
                name not in _COLLECTIVE_OPS or name in _COLLECTIVE_WAITS:
            return
        kind = _COLLECTIVE_OPS.get(name)
        if kind is None:
            raise ValueError(f"the trace met collective {name}, of no "
                             f"known kind")
        result = args[0] if ns == "c10d" else out
        n = sum(map(_nbytes, _tensors(result)))
        self.collectives[kind]["bytes"] += n
        self.collectives[kind]["count"] += 1
        self.collective_log.append((name, kind, n))


def collectives_record(mode: CostMode) -> dict:
    """The JAX dry run's ``collectives`` dict: each kind and
    ``total_bytes``."""
    out = {k: dict(v) for k, v in mode.collectives.items()}
    out["total_bytes"] = sum(v["bytes"] for v in mode.collectives.values())
    return out


def _local(x) -> torch.Tensor:
    return getattr(x, "_local_tensor", x)


def _storages(tree) -> dict:
    """{storage key: bytes} of the local tensors of a tree's leaves."""
    out = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            s = _local(x).untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def trace(fn: Callable, args: tuple, donate: tuple = ()) -> dict:
    """``fn(*args)`` once under ``CostMode``, with ``args`` (plain or
    ``DTensor`` tensors, fake or real) live throughout: the cost,
    collectives and memory of one device (rank 0's shards), as the JAX
    dry run's record holds them.

    ``memory.argument_bytes`` is the arguments' local storage bytes;
    ``output_bytes`` those of the result's distinct storages;
    ``alias_bytes`` those of its storages that are storages of the
    arguments in ``donate`` (written in place); ``temp_bytes`` the peak
    of live storage bytes less the arguments and the outputs that are
    not aliased; ``code_bytes`` is ``None`` (no program is compiled).
    ``seconds`` is the trace's time."""
    mode = CostMode()
    arg_storages = _storages(args)
    donated = set(_storages([args[i] for i in donate]))
    was_enabled = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        for x in tree_leaves(args):
            if isinstance(x, torch.Tensor):
                mode.track(_local(x))
        with mode.entered():
            out = fn(*args)
        seconds = time.perf_counter() - t0
        outputs = _storages(out)
        record = {
            "cost": {"flops_per_device": float(mode.flops),
                     "bytes_accessed_per_device":
                         float(mode.bytes_accessed)},
            "collectives": collectives_record(mode),
            "memory": _memory(mode.peak_bytes, arg_storages, outputs,
                              donated),
            "seconds": seconds,
        }
    finally:
        if was_enabled:
            gc.enable()
    return record


def _memory(peak: int, arg_storages: dict, outputs: dict,
            donated: set) -> dict:
    args = sum(arg_storages.values())
    alias = sum(n for k, n in outputs.items() if k in donated)
    # An output that is a non-donated argument itself is no new bytes.
    fresh = sum(n for k, n in outputs.items() if k not in arg_storages)
    return {"argument_bytes": args,
            "output_bytes": sum(outputs.values()),
            "temp_bytes": peak - args - fresh,
            "alias_bytes": alias,
            "code_bytes": None}


# -- the cells on fake tensors ----------------------------------------------
def fake_args(low, mesh, fake_mode) -> tuple:
    """Rank 0's shards of ``low.args`` as fake tensors under
    ``fake_mode``, each leaf a ``DTensor`` placed under its sanitized
    spec on ``mesh`` (a ``launch.mesh.Mesh`` over a process group), or
    a plain fake tensor where its spec is ``None``."""
    from torch.distributed.tensor import DTensor

    from ..distributed import sharding as shd

    specs = shd.sanitize_specs(low.in_specs, low.args, mesh)
    device = mesh.device_mesh.device_type

    def leaf(spec, meta: torch.Tensor):
        with fake_mode:
            if spec is None:
                return torch.empty(meta.shape, dtype=meta.dtype,
                                   device=device)
            sharding = shd.named(mesh, spec)
            local = tuple(
                hi - lo for lo, hi in
                (shd.shard_ranges(n, sharding.device_mesh,
                                  sharding.placements, d)[-1]
                 for d, n in enumerate(meta.shape)))
            t = torch.empty(local, dtype=meta.dtype, device=device)
            return DTensor.from_local(
                t, sharding.device_mesh, sharding.placements,
                run_check=False, shape=meta.shape,
                stride=torch.empty(meta.shape, device="meta").stride())

    return tuple(shd.tree_map(leaf, s, a, is_leaf=shd.is_spec_leaf)
                 for s, a in zip(specs, low.args))


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks while the block runs (this
    process rank 0; collectives move nothing), then destroyed.  Raises
    if a default process group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's trace makes its own fake process "
                           "group: destroy the default one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_cell(arch, shape: str, sizes: tuple) -> dict:
    """``trace`` of the cell ``shape`` of ``arch`` (a
    ``configs.common.ArchDef``): its lowering on a host mesh of ``sizes``
    ((data, model) or (pod, data, model)) over a fake process group of
    their product, its ``fn`` run on rank 0's fake shards of the
    lowering's arguments."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distributed.context import mesh_context
    from .mesh import make_host_mesh

    with fake_process_group(math.prod(sizes)):
        mesh = make_host_mesh(*sizes[-2:],
                              pod=sizes[0] if len(sizes) == 3 else None)
        low = arch.lowering(shape, mesh)
        fake_mode = FakeTensorMode()
        args = fake_args(low, mesh, fake_mode)
        with mesh_context(mesh), fake_mode:
            return trace(low.fn, args, low.donate)
