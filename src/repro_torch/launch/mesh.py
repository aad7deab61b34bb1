"""Meshes: the production shapes, and small meshes over a process group.

A port ``Mesh`` is the JAX mesh's axis names and sizes, and where a
process group of its size is up, the ``torch.distributed`` ``DeviceMesh``
over it (one rank a device).  The production meshes are the JAX
package's, (16, 16) and (2, 16, 16): no group of 256 or 512 ranks exists
here, so they are abstract (no devices), which is all that
``sharding.sanitize_specs`` and the dry run read.  ``make_host_mesh``
builds a real one over the current process group: on the card under
NCCL, on the CPU under gloo.  Importing this module touches no device
and no process group.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_mesh: Any = None     # a DeviceMesh, or None (abstract)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, abstract: (16 data, 16 model),
    or (2 pod, 16, 16) with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1,
                   pod: int | None = None) -> Mesh:
    """A (data, model) or (pod, data, model) mesh over the current process
    group, whose size must be the mesh's: a ``DeviceMesh`` on "cuda" under
    NCCL, on "cpu" under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    names, sizes = (("pod", "data", "model"), (pod, data, model)) if pod \
        else (("data", "model"), (data, model))
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: "
                           "initialize_distributed() or "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} ranks; "
                         f"the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(names, sizes, init_device_mesh(device_type, sizes,
                                               mesh_dim_names=names))


def initialize_distributed() -> None:
    """Multi-process bring-up: with ``REPRO_COORDINATOR`` (host:port) set,
    join the process group of ``REPRO_NUM_PROCESSES`` ranks as rank
    ``REPRO_PROCESS_ID``, under NCCL when a card is in use (each rank on
    card ``rank % count``) and gloo otherwise.  Without it, a no-op."""
    if not os.environ.get("REPRO_COORDINATOR"):
        return
    rank = int(os.environ.get("REPRO_PROCESS_ID", "0"))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{os.environ['REPRO_COORDINATOR']}",
        world_size=int(os.environ.get("REPRO_NUM_PROCESSES", "1")),
        rank=rank)
