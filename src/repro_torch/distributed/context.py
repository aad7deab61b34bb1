"""Mesh-axis context: lets code place sharding constraints by axis
*name* without holding mesh objects.

Launchers declare the active axis names once (``mesh_context``);
``constrain`` then applies only the axes that exist, so the same code
runs unconstrained on one device, TP-only on a pod, or DP×TP×pod on the
full mesh.  As the JAX package's ``with_sharding_constraint`` moves an
array, ``constrain`` redistributes a ``DTensor`` to the spec's
placements on its own mesh; a plain tensor has no placement to change
and comes back as it was.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar

import torch

from .sharding import PartitionSpec as P
from .sharding import entry_axes, placements

_AXES: ContextVar[tuple[str, ...]] = ContextVar("repro_torch_mesh_axes",
                                                default=())


def set_mesh_axes(axes: tuple[str, ...]) -> None:
    _AXES.set(tuple(axes))


def mesh_axes() -> tuple[str, ...]:
    return _AXES.get()


@contextlib.contextmanager
def mesh_context(mesh):
    token = _AXES.set(tuple(mesh.axis_names))
    try:
        yield mesh
    finally:
        _AXES.reset(token)


def _filter(entry, axes):
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    kept = tuple(n for n in names if n in axes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def constrain(x: torch.Tensor, *spec_dims) -> torch.Tensor:
    """``x`` placed as ``P(*spec_dims)``, dropping axis names not on the
    active mesh (or on ``x``'s own), and leaving whole a dim of one or
    one that their ranks do not divide.  No-op without a mesh, and on a
    tensor that is not a ``DTensor``."""
    axes = mesh_axes()
    if not axes:
        return x
    dims = tuple(_filter(d, axes) for d in spec_dims)
    if all(d is None for d in dims):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.shape))
    kept = []
    for n, d in zip(x.shape, dims):
        d = _filter(d, names)
        parts = math.prod(sizes[a] for a in entry_axes(d))
        # As ``sanitize_specs`` does for inputs: a dim that does not
        # split evenly, or a single row, stays whole.
        kept.append(None if n == 1 or n % parts else d)
    want = placements(names, P(*kept))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


DP = ("pod", "data")   # canonical batch-parallel axes
# Nodes and edges of a graph shard over every mesh axis (the JAX
# package's ``models.nequip.GRAPH_AXES``).
GRAPH_AXES = ("pod", "data", "model")
