"""Sharding rules: param path → PartitionSpec, per model family — plus
the consistent-hash ring that routes plan-cache keys to shards.

The JAX package's ``distributed/sharding.py`` with its logic unchanged,
over the port's trees.  Rules are name-based (like MaxText's logical-axis
rules): one function reads a leaf's path and shape and returns its spec,
in axis *names* ("data", "model", and optionally "pod"), so the same
model lowers on any mesh: single-pod (16, 16), multi-pod (2, 16, 16), or
the small CPU meshes of the tests.

Conventions:
 * TP: attention heads / FFN hidden / vocab / MoE experts → "model".
 * Batch-like inputs → ("pod", "data") for training (pod = outer DP).
 * Optimizer state (m/v): the param spec with "data" added on the first
   open dim — ZeRO-1 style state sharding.
 * Stacked-layer params (leading layer dim) get None prepended.

Specs are the port's own ``PartitionSpec``: an immutable tuple of
``None``, an axis name or a tuple of names, one entry a tensor dim, that
compares as JAX's does.  Trees are nested dicts and lists (a train
state, a cache), and a leaf's path is its keys joined by ``/``: the
train state's keys already are the JAX tree's paths
(``"groups/0/attn/wq"``), so a rule splits a path on ``/``.  ``named``
turns a spec into a ``torch.distributed.tensor`` placement on a mesh
(``launch.mesh``).
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import math
from typing import Any, Callable, Iterable, NamedTuple


# ---------------------------------------------------------------------------
# Consistent-hash routing (DESIGN.md §7)
#
# Plan-cache keys are stable sha256 content hashes
# (``Request.canonical_hash``), so the routing point is simply the key's
# leading 64-bit hex prefix — already uniform, never rehashed.  Shards
# get ``replicas`` virtual points on the ring, which keeps balance
# within a few percent and makes shard add/remove move only ~1/N of the
# key space (the classic consistent-hashing guarantee the rebalance
# tests pin down).
# ---------------------------------------------------------------------------

PREFIX_HEX = 16        # leading hex chars of a key → 64-bit ring point
RING_SPACE = 2 ** (4 * PREFIX_HEX)


def key_point(key: str) -> int:
    """Ring position of a canonical-hash key: its 64-bit hex prefix."""
    return int(key[:PREFIX_HEX], 16)


class HashRing:
    """Consistent-hash ring over named shards.

    Lock-free readers: the ring state is one tuple
    ``(nodes, points, owners)`` that mutators rebuild and swap with a
    single attribute store, so a concurrent ``route`` sees either the
    old or the new ring, never a half-built one.  Mutations themselves
    are admin-plane — callers (``ShardedPlanCache.add_shard``) serialize
    them externally.
    """

    def __init__(self, nodes: Iterable[str] = (), replicas: int = 64):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = replicas
        self._state: tuple[tuple[str, ...], tuple[int, ...],
                           tuple[str, ...]] = ((), (), ())
        for node in nodes:
            self.add_node(node)

    @property
    def nodes(self) -> tuple[str, ...]:
        """Shard names in insertion order."""
        return self._state[0]

    def __len__(self) -> int:
        return len(self._state[0])

    def __contains__(self, node: str) -> bool:
        return node in self._state[0]

    @staticmethod
    def _virtual_points(node: str, replicas: int) -> list[int]:
        return [int(hashlib.sha256(f"{node}#{i}".encode()).hexdigest()
                    [:PREFIX_HEX], 16) for i in range(replicas)]

    def _rebuild(self, nodes: tuple[str, ...]) -> None:
        ring = sorted((p, n) for n in nodes
                      for p in self._virtual_points(n, self.replicas))
        self._state = (nodes, tuple(p for p, _ in ring),
                       tuple(n for _, n in ring))

    def add_node(self, node: str) -> None:
        nodes = self._state[0]
        if node in nodes:
            raise ValueError(f"shard {node!r} already on the ring")
        self._rebuild(nodes + (node,))

    def remove_node(self, node: str) -> None:
        nodes = self._state[0]
        if node not in nodes:
            raise KeyError(node)
        self._rebuild(tuple(n for n in nodes if n != node))

    def route(self, key: str) -> str:
        """Owning shard of a canonical-hash key (clockwise successor of
        the key's 64-bit prefix point on the ring)."""
        _, points, owners = self._state
        if not owners:
            raise RuntimeError("HashRing has no nodes")
        i = bisect.bisect_right(points, key_point(key))
        return owners[i % len(owners)]


# ---------------------------------------------------------------------------
# Partition specs and trees of them
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (not sharded), a mesh axis name,
    or a tuple of names (sharded over their product, major to minor).
    As in JAX, a list entry becomes a tuple, a one-name tuple becomes the
    name and an empty one ``None``; ``P()`` is "replicated", and two
    specs are equal when their entries are."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_entry(d) for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def _entry(d):
    if isinstance(d, (tuple, list)):
        names = tuple(d)
        if not names or names == (None,):
            return None
        return names[0] if len(names) == 1 else names
    return d


def entry_axes(d) -> tuple:
    """The axis names of one spec entry (``None``, a name or a tuple of
    names), major first."""
    if d is None:
        return ()
    return d if isinstance(d, tuple) else (d,)


def is_spec_leaf(x) -> bool:
    return isinstance(x, PartitionSpec) or x is None


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable = lambda x: False) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (a spec
    is a leaf), with the matching leaves of ``rest``."""
    if not is_leaf(tree) and not isinstance(tree, PartitionSpec):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v, *(r[k] for r in rest),
                                is_leaf=is_leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                       is_leaf=is_leaf)
                              for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over nested dicts and lists, ``path`` the keys
    (a list's indices) joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return fn(path, tree)
    out = {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
           for k, v in items}
    return out if isinstance(tree, dict) else type(tree)(out.values())


def _path_names(path) -> list[str]:
    """A leaf's path as its parts: a ``/``-joined string is split, a
    sequence of parts (keys, indices, JAX path entries) read part by
    part."""
    if isinstance(path, str):
        return path.split("/")
    return [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# Family rules
# ---------------------------------------------------------------------------

def lm_rules(path, shape: tuple[int, ...]) -> P:
    """Transformer sharding (GQA / MLA / MoE / dense)."""
    names = _path_names(path)
    leaf = names[-1]
    stacked = "groups" in names         # stacked layers → leading L dim
    inner = shape[1:] if stacked else shape

    def spec(*dims):
        full = (None,) + dims if stacked else dims
        return P(*full[: len(shape)])

    if leaf in ("scale", "bias", "b"):
        return spec(None)
    if "router" in names:
        return spec(None, None)
    if leaf in ("w_gate", "w_up") and len(inner) == 3:     # MoE (E, D, F)
        return spec("model", None, None)
    if leaf == "w_down" and len(inner) == 3:               # MoE (E, F, D)
        return spec("model", None, None)
    if "embed" in names or leaf == "table":                # (V, D)
        return spec("model", None)
    if leaf in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
        return spec(None, "model")                         # (…, H·Dh)
    if leaf in ("wq_a", "wkv_a"):
        return spec(None, "model")                         # low-rank in
    if leaf == "wo":
        return spec("model", None)                         # (H·Dh, D)
    if leaf in ("w_gate", "w_up"):                         # dense (D, F)
        return spec(None, "model")
    if leaf == "w_down":                                   # dense (F, D)
        return spec("model", None)
    if leaf == "w":                                        # generic dense
        if len(inner) == 2:
            return spec(None, "model")
        return spec(*([None] * len(inner)))
    return P(*([None] * len(shape)))


def gnn_rules(path, shape: tuple[int, ...]) -> P:
    """NequIP params are tiny — replicate everything."""
    return P(*([None] * len(shape)))


def recsys_rules(path, shape: tuple[int, ...]) -> P:
    names = _path_names(path)
    leaf = names[-1]
    if leaf == "tables" and len(shape) == 3:     # (T, rows, D) row-shard
        return P(None, "model", None)
    if leaf == "table" and len(shape) == 2:      # (rows, D) row-shard
        return P("model", None)
    if ("tower" in " ".join(names) or "deep" in names or "top" in names
            or "bot" in names) and leaf == "w" and len(shape) == 2:
        return P(None, None)                     # small MLPs replicated
    # bert4rec reuses the transformer
    return lm_rules(path, shape)


RULES: dict[str, Callable] = {
    "lm": lm_rules,
    "gnn": gnn_rules,
    "recsys": recsys_rules,
}


def param_specs(params: Any, rules: Callable) -> Any:
    """PartitionSpec tree matching ``params`` (each leaf's path and
    shape through ``rules``)."""
    return tree_map_with_path(lambda path, leaf: rules(path, _shape(leaf)),
                              params)


DATA_AXIS_SIZE = 16   # production data-axis extent (per pod)
POD_AXIS_SIZE = 2     # pods on the multi-pod mesh

# FSDP shards over data *and* pod: 671B-class models only fit when the
# cross-pod axis also carries parameter shards (sanitize_specs degrades
# this to data-only on single-pod meshes).
FSDP_AXES = ("data", "pod")


def add_data_axis(spec: P, shape: tuple[int, ...],
                  min_size: int = 2 ** 16,
                  data_size: int = DATA_AXIS_SIZE * POD_AXIS_SIZE,
                  axes: tuple = FSDP_AXES) -> P:
    """Add the FSDP axes on the first open, evenly divisible dim of a
    ≥2-D tensor (ZeRO/FSDP).  Dims not divisible by the full extent are
    skipped, as JAX's input shardings require exact division."""
    if len(shape) < 2 or math.prod(shape) < min_size:
        return spec
    flat = [a for d in spec for a in entry_axes(d)]
    if any(a in flat for a in axes):
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, d in enumerate(dims):
        if d is None and shape[i] > 1 and shape[i] % data_size == 0:
            dims[i] = axes
            break
    return P(*dims)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a port mesh (``launch.mesh.Mesh``)."""
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def sanitize_specs(spec_tree: Any, aval_tree: Any, mesh) -> Any:
    """Make spec trees legal for this mesh: drop axis names the mesh
    does not have (rules may speak of "pod" on single-pod meshes), and
    drop axes whose product doesn't divide the dim size.

    Published configs have plenty of awkward extents (49155-token
    vocabs, 26 tables, 61 layers): any non-divisible dim falls back to
    replication on that dim, everything else keeps its sharding."""
    sizes = axis_sizes(mesh)

    def fix(spec, aval):
        if not isinstance(spec, P):
            return spec
        shape = _shape(aval)
        out = []
        for i, d in enumerate(list(spec)[: len(shape)]):
            axes = tuple(a for a in entry_axes(d) if a in sizes)
            if not axes or shape[i] % math.prod(sizes[a] for a in axes):
                out.append(None)
            else:
                out.append(axes if len(axes) > 1 else axes[0])
        return P(*out)

    return tree_map(fix, spec_tree, aval_tree, is_leaf=is_spec_leaf)


def opt_state_specs(pspec_tree: Any, params: Any,
                    min_size: int = 2 ** 16) -> Any:
    """ZeRO-1: add "data" on the first open dim of each ≥2-D param."""
    return tree_map(
        lambda spec, leaf: add_data_axis(spec, _shape(leaf), min_size),
        pspec_tree, params, is_leaf=is_spec_leaf)


def fsdp_rules(base_rules: Callable) -> Callable:
    """Wrap family rules with FSDP: params additionally shard on "data".

    Embedding tables are exempt, as in the JAX package (whose token
    gather over a table sharded on both vocab and feature dims falls
    back to a full rematerialisation)."""
    def rules(path, shape):
        names = _path_names(path)
        if "embed" in names or names[-1] == "table":
            return base_rules(path, shape)
        return add_data_axis(base_rules(path, shape), shape)

    return rules


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh, as ``torch.distributed.tensor``
    takes it: ``distribute_tensor(t, *sharding)``.  ``device_mesh`` is
    None on an abstract mesh (sizes only)."""
    device_mesh: Any
    placements: tuple


def placements(axis_names, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on a mesh of ``axis_names``: one
    per mesh dim,
    ``Shard(i)`` on each axis that tensor dim ``i`` names (a tuple of
    names: on each of them) and ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_names)
    out: list = [Replicate()] * len(names)
    for i, d in enumerate(spec):
        for a in entry_axes(d):
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not on the mesh "
                                 f"{names}")
            j = names.index(a)
            if isinstance(out[j], Shard):
                raise ValueError(f"{spec}: axis {a!r} named twice")
            out[j] = Shard(i)
    return tuple(out)


def named(mesh, spec_tree: Any) -> Any:
    """Each spec leaf of ``spec_tree`` as a ``NamedSharding`` on
    ``mesh`` (``None`` stays ``None``)."""
    return tree_map(
        lambda s: None if s is None else
        NamedSharding(mesh.device_mesh, placements(mesh.axis_names, s)),
        spec_tree, is_leaf=is_spec_leaf)


def batch_axes(mesh) -> tuple:
    """The combined data-parallel axes present on this mesh."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else (mesh.axis_names[0],)


# ---------------------------------------------------------------------------
# DTensor placements, and a DTensor's local tensor and back
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed.tensor.DTensor``."""
    import torch.distributed as dist

    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_ranges(n: int, mesh, placements, dim: int = 0,
                 coord=None) -> list:
    """The global indices ``[lo, hi)`` along ``dim`` (of size ``n``) of
    this rank's part of a ``DTensor`` placed ``placements`` on ``mesh``
    (a ``DeviceMesh``), or of the part of the rank at mesh coordinate
    ``coord``: first ``(0, n)``, then the range after each mesh dim that
    shards ``dim``, in mesh order.  Each such mesh dim cuts the current
    range into ``torch.chunk`` pieces (ceil-sized, the last ones shorter
    or empty), as ``DTensor`` lays shards out."""
    ranges = [(0, int(n))]
    if coord is None:
        coord = mesh.get_coordinate()
    for j, pl in enumerate(placements):
        if pl.is_shard(dim):
            lo, hi = ranges[-1]
            size = -(-(hi - lo) // mesh.size(j))
            lo = min(lo + coord[j] * size, hi)
            ranges.append((lo, min(lo + size, hi)))
    return ranges


def local_range(x, dim: int) -> tuple[int, int]:
    """The global indices ``[lo, hi)`` along ``dim`` of this rank's shard
    of the ``DTensor`` ``x`` (``shard_ranges``'s last)."""
    return shard_ranges(x.shape[dim], x.device_mesh, x.placements, dim)[-1]


def replicate_like(t, like):
    """``t``, the same on every rank, as a replicated ``DTensor`` on the
    mesh of ``like`` where ``like`` is a ``DTensor``; else ``t`` itself.
    For the constants a model builds beside its sharded tensors (index
    tables, Gaunt coefficients, ramps)."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def row_ids(x):
    """``torch.arange(x.shape[0])`` (int64) on ``x``'s device; on a mesh,
    a ``DTensor`` placed as ``x``'s dim 0 (each rank its own rows'
    ids)."""
    import torch

    if not is_dtensor(x):
        return torch.arange(x.shape[0], device=x.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lo, hi = local_range(x, 0)
    mesh = x.device_mesh
    return DTensor.from_local(
        torch.arange(lo, hi, device=x.device), mesh,
        [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements],
        run_check=False, shape=(int(x.shape[0]),), stride=(1,))


def rowwise(fn, x, *rest):
    """``fn(x, *rest)`` where it only mixes values within a row of dim 0,
    every tensor of ``rest`` holding the same rows as ``x`` (labels,
    masks).  On a mesh (``x`` a ``DTensor``): each placed with dim 0
    kept sharded as ``x``'s and every other dim whole, ``fn`` run on the
    local tensors, and the result (dim 0 ``x``'s rows) placed as those
    rows.  Constants ``fn`` reads whole go in its closure (``whole``).
    For what DTensor lacks a rule for, or would spread over ranks: a
    row's softmax, an index of a row's own entries."""
    if not is_dtensor(x):
        return fn(x, *rest)
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    local = [local_of(replicate_like(t, x).redistribute(mesh, rows))
             for t in (x, *rest)]
    out = fn(*local)
    return dtensor_of(out, mesh, rows,
                      (int(x.shape[0]),) + tuple(out.shape[1:]))


def unflatten(x, dim: int, sizes: tuple):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  On a
    ``DTensor`` whose ``dim`` is sharded over mesh dims whose product
    does not divide ``sizes[0]`` (heads that do not split evenly over
    "model": GLM-4's 2 KV heads over 4 ranks, Yi's 7), that dim is made
    whole on those mesh dims first, as ``DTensor`` cannot place such a
    split; else the shards stay where they are."""
    dim = dim % x.ndim
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        parts = math.prod(mesh.size(j) for j, p in enumerate(x.placements)
                          if p.is_shard(dim))
        if sizes[0] % parts:
            want = [Replicate() if p.is_shard(dim) else p
                    for p in x.placements]
            x = x.redistribute(mesh, want)
    return x.reshape(shape)


def shard_as(x, dim: int, w, w_dim: int):
    """``x`` with ``dim`` sharded on each mesh dim that shards ``w``'s
    ``w_dim`` and replicates ``x`` there (when the ranks divide it): the
    input of a product ``x @ w`` contracted over those dims, split where
    the weight is (a local slice).  Its gradient is gathered back on
    that dim, as the reshape before it needs where it had to keep the
    dim whole (heads that do not split, ``unflatten``).  Plain tensors
    pass through."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    mesh = x.device_mesh
    want, parts = list(x.placements), 1
    for j, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if wp.is_shard(w_dim) and xp.is_replicate():
            want[j] = Shard(dim)
            parts *= mesh.size(j)
    if parts == 1 or x.shape[dim] % parts:
        return x
    return x.redistribute(mesh, want)


def at_use(t):
    """A parameter as a layer uses it: a ``DTensor`` sharded on the FSDP
    axes ("data", "pod") all-gathered over them (its other placements
    kept), so that the layer's products run on the weight whole over
    the batch's ranks and the activations stay where they are; its
    gradient is reduce-scattered back onto those axes in the backward.
    Any other tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    names = t.device_mesh.mesh_dim_names or ()
    want = tuple(Replicate() if n in FSDP_AXES and p.is_shard() else p
                 for n, p in zip(names, t.placements))
    return t if want == tuple(t.placements) else t.redistribute(
        t.device_mesh, want)


def placed_zeros(shape: tuple, dtype, device_mesh, spec: P):
    """Zeros of global ``shape`` as a ``DTensor`` on ``device_mesh``
    placed by ``spec``, first made legal for the mesh (axes it lacks, or
    whose product does not divide the dim, dropped: ``sanitize_specs``);
    each rank allocates only its own part."""
    import torch
    from torch.distributed.tensor import zeros

    from ..launch.mesh import Mesh

    names = tuple(device_mesh.mesh_dim_names)
    spec = sanitize_specs(spec, torch.empty(shape, device="meta"),
                          Mesh(names, tuple(device_mesh.shape)))
    return zeros(tuple(shape), dtype=dtype, device_mesh=device_mesh,
                 placements=placements(names, spec))


def whole(t):
    """The whole of a replicated ``DTensor`` as this rank's tensor (its
    local tensor); any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


@functools.lru_cache(maxsize=None)
def _boundary():
    """A ``DTensor``'s local tensor and back, as autograd Functions each
    the other's backward: a graph that crosses them differentiates again
    (a force's gradient).  ``DTensor.to_local``/``from_local`` build
    their gradients outside the graph in some PyTorch releases, which
    drops the second-order terms."""
    import torch
    from torch.distributed.tensor import DTensor

    class ToLocal(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, grad_placements):
            ctx.meta = (x.device_mesh, tuple(grad_placements),
                        tuple(x.shape))
            return x.to_local().detach()

        @staticmethod
        def backward(ctx, grad):
            mesh, pls, shape = ctx.meta
            return FromLocal.apply(grad, mesh, pls, shape), None

    class FromLocal(torch.autograd.Function):
        @staticmethod
        def forward(ctx, local, mesh, placements, shape):
            ctx.meta = (mesh, tuple(placements))
            stride = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                stride[i] = stride[i + 1] * shape[i + 1]
            return DTensor.from_local(local.detach().contiguous(), mesh,
                                      placements,
                                      run_check=False, shape=shape,
                                      stride=tuple(stride))

        @staticmethod
        def backward(ctx, grad):
            from torch.distributed.tensor import Replicate

            mesh, pls = ctx.meta
            # Each rank's term of a partial sum takes the whole gradient:
            # a gradient that arrives as a partial sum (or sharded) is
            # summed (gathered) first.
            want = tuple(Replicate() if p.is_partial() else p
                         for p in pls)
            if want != tuple(grad.placements):
                grad = grad.redistribute(mesh, want)
            return ToLocal.apply(grad, want), None, None, None

    return ToLocal, FromLocal


def local_of(x, grad_placements=None):
    """``x.to_local(grad_placements=...)`` of a ``DTensor``, through
    ``_boundary``: differentiable any number of times."""
    to_local, _ = _boundary()
    return to_local.apply(x, tuple(grad_placements or x.placements))


def dtensor_of(local, mesh, placements, shape: tuple):
    """``DTensor.from_local`` of ``local`` as a tensor of global ``shape``
    (contiguous) placed ``placements`` on ``mesh`` (a ``DeviceMesh``),
    through ``_boundary``: differentiable any number of times."""
    _, from_local = _boundary()
    return from_local.apply(local, mesh, tuple(placements),
                            tuple(int(d) for d in shape))
