"""Atomic checkpoints in the JAX package's on-disk format, sharded
where the state is.

Layout (one directory per step), as the JAX package's
``train.checkpoint`` writes it::

  ckpt_dir/
    step_000000123/
      manifest.json          # tree paths, shapes, dtypes, shard indices
      shard_h<k>.npz         # rank k's arrays, keyed "<path>#<index>"
    LATEST                   # atomically updated pointer file

Keys are the JAX package's tree paths (``params/bags/tables``,
``opt/m/bot/layers/0/w``, ``opt/step``): the port's state is nested
dicts whose leaf keys already are those paths, so each package restores
the other's checkpoints.  A state of plain tensors is written by one
process as whole arrays (one shard index spanning each leaf's shape).
A state of ``DTensor`` tensors (``distributed.sharding.named``) is written
by every rank of the process group: each distinct shard once, by the
rank that holds it at coordinate 0 of every mesh dim it is replicated
over, into that rank's ``shard_h<rank>.npz``, with its index ranges;
rank 0 writes the manifest of all of them and ``LATEST`` once every
rank's file is in place.  A restore reads either, and the JAX package's
sharded leaves (several index ranges) and host-array leaves (index
``null``).  ``restore_checkpoint(..., shardings=)`` places each leaf on
a mesh that may differ from the one that saved (elastic restore): each
rank reads only the index ranges its own shard needs.

``save_checkpoint`` copies the state to host memory before it returns
(the next step updates the tensors in place), and writes the files on a
thread unless ``blocking``.  A checkpoint becomes visible only when its
directory and then ``LATEST`` are renamed into place.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

SEP = "/"
HOST = 0         # the one process of a plain-tensor state
COMMIT_TIMEOUT_S = 600.0    # rank 0's wait for the other ranks' files


def flatten_tree(tree: Any, prefix: str = "",
                 is_leaf=lambda x: False) -> dict[str, Any]:
    """Nested dicts and lists → {path: leaf}, the path's parts joined by
    ``/`` (a list's parts are the indices)."""
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{SEP}{k}" if prefix
                                 else str(k), is_leaf))
    return flat


def tree_paths(tree: Any) -> list[str]:
    return list(flatten_tree(tree))


def _host_copy(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _is_sharded(leaf) -> bool:
    """Whether ``leaf`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _tag(index) -> str:
    return "_".join(f"{a}-{b}" for a, b in index) or "scalar"


def _index(shape) -> tuple[str, list]:
    full = [[0, int(d)] for d in shape]
    return _tag(full), full


def shard_index(shape, placements, coordinate, mesh_sizes) -> list:
    """The index ranges ``[[a, b], ...]`` of the shard at mesh
    ``coordinate`` of a tensor of ``shape`` placed by ``placements``:
    each ``Shard(d)`` cuts tensor dim d's current range into
    ``torch.chunk`` pieces (ceil-sized, the last ones shorter or empty),
    mesh dims in order, as ``DTensor`` lays shards out."""
    from torch.distributed.tensor import Replicate, Shard

    index = [[0, int(d)] for d in shape]
    for j, pl in enumerate(placements):
        if isinstance(pl, Shard):
            a, b = index[pl.dim]
            size = -(-(b - a) // mesh_sizes[j])
            lo = min(a + coordinate[j] * size, b)
            index[pl.dim] = [lo, min(lo + size, b)]
        elif not isinstance(pl, Replicate):
            raise ValueError(f"cannot checkpoint a {pl} placement")
    return index


def _shards_of(leaf) -> tuple[list, list | None]:
    """(every distinct shard of a DTensor as (rank, index), the index
    this rank writes or None): a shard's writer is the rank at coordinate
    0 of each mesh dim the tensor is replicated over."""
    from torch.distributed.tensor import Shard

    mesh, pls = leaf.device_mesh, tuple(leaf.placements)
    sizes = tuple(mesh.shape)
    ranks = mesh.mesh
    coords = itertools.product(*(
        range(n) if isinstance(pl, Shard) else (0,)
        for n, pl in zip(sizes, pls)))
    shards, seen = [], set()
    for c in coords:
        index = shard_index(leaf.shape, pls, c, sizes)
        if _tag(index) not in seen:
            seen.add(_tag(index))
            shards.append((int(ranks[c]), index))
    mine = mesh.get_coordinate()
    own = None
    if mine is not None and all(isinstance(pl, Shard) or k == 0
                                for k, pl in zip(mine, pls)):
        index = shard_index(leaf.shape, pls, mine, sizes)
        if (dist.get_rank(), index) in shards:
            own = index
    return shards, own


def _snapshot(flat: dict, rank: int) -> tuple[dict, dict]:
    """(this rank's arrays, the manifest's tree): each DTensor leaf's
    distinct shards, each written by one rank; each other leaf whole,
    written by rank 0."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, leaf in flat.items():
        if _is_sharded(leaf):
            shards, own = _shards_of(leaf)
            if own is not None:
                local = leaf.to_local()
                want = tuple(b - a for a, b in own)
                if tuple(local.shape) != want:
                    raise RuntimeError(f"{key}: local shard "
                                       f"{tuple(local.shape)}, expected "
                                       f"{want} from its placements")
                arrays[f"{key}#{_tag(own)}"] = _host_copy(local)
            meta[key] = {"shape": list(leaf.shape),
                         "dtype": str(_np_dtype(leaf.dtype)),
                         "shards": [{"index": index,
                                     "file_key": f"{key}#{_tag(index)}",
                                     "host": host}
                                    for host, index in shards]}
        else:
            arr = _host_copy(leaf)
            tag, index = _index(arr.shape)
            if rank == 0:
                arrays[f"{key}#{tag}"] = arr
            meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                         "shards": [{"index": index,
                                     "file_key": f"{key}#{tag}",
                                     "host": 0}]}
    return arrays, meta


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, state: Any,
                    blocking: bool = True) -> threading.Thread | None:
    """Write ``state`` (nested dicts of tensors, DTensors or arrays) for
    ``step``.  The host copy is taken before this returns; with
    ``blocking=False`` the files are written on the returned thread.  A
    state with DTensor leaves is saved by every rank of the process
    group together; with ``blocking`` each returns once the checkpoint
    is committed."""
    ckpt_dir = Path(ckpt_dir)
    flat = flatten_tree(state)
    sharded = any(_is_sharded(leaf) for leaf in flat.values())
    host, n_hosts = (dist.get_rank(), dist.get_world_size()) if sharded \
        else (HOST, 1)
    arrays, meta = _snapshot(flat, host)

    def write():
        step_dir = ckpt_dir / f"step_{step:09d}"
        tmp = ckpt_dir / f".tmp_step_{step:09d}_h{host}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard_h{host}.npz", **arrays)
        step_dir.mkdir(parents=True, exist_ok=True)
        for f in tmp.iterdir():
            os.replace(f, step_dir / f.name)
        tmp.rmdir()
        if host != 0:
            return
        # Every rank writes its file, so their presence is the barrier.
        deadline = time.monotonic() + COMMIT_TIMEOUT_S
        while not all((step_dir / f"shard_h{k}.npz").exists()
                      for k in range(n_hosts)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"checkpoint step {step}: the other "
                                   f"ranks' shards did not arrive")
            time.sleep(0.01)
        (step_dir / "manifest.json").write_text(json.dumps(
            {"step": step, "tree": meta, "n_hosts": n_hosts,
             "time": time.time()}, indent=1))
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, ckpt_dir / "LATEST")   # atomic commit

    if blocking:
        write()
        if sharded:
            dist.barrier()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore_checkpoint(ckpt_dir: str | os.PathLike, step: int,
                       target: Any, shardings: Any | None = None) -> Any:
    """Restore ``step`` into ``target`` (nested dicts of tensors, such as
    a train state) and return it.  Every leaf of the target must be in
    the checkpoint with its shape and dtype, and the saved shards must
    cover what this rank reads of it: all of that is checked before the
    first leaf is written, so a restore that raises leaves the target as
    it was.

    Without ``shardings``, in place: a plain tensor receives the whole
    leaf and a DTensor its own shard.
    ``shardings`` is a matching tree of ``sharding.named`` placements,
    which may describe another mesh than the one that saved: each leaf
    with one comes back as a DTensor so placed, built from the index
    ranges this rank's shard needs (a target DTensor already so placed
    is written in place and kept); a leaf whose sharding is None is
    written in place.  The target's leaves then only give the shapes and
    dtypes (``meta`` tensors will do)."""
    step_dir = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    arrays = {}
    for f in sorted(step_dir.glob("shard_h*.npz")):
        arrays.update(_open_shards(f))
    flat_shard = flatten_tree(shardings, is_leaf=_is_named) \
        if shardings is not None else {}
    plans = {}
    for key, leaf in flatten_tree(target).items():
        info = manifest["tree"].get(key)
        if info is None:
            raise KeyError(f"checkpoint step {step}: no leaf {key!r}")
        _check_leaf(step, key, info, leaf)
        placement = _placement(leaf, flat_shard.get(key))
        index = _index(leaf.shape)[1] if placement is None else \
            shard_index(leaf.shape, placement[1], placement[0]
                        .get_coordinate(), tuple(placement[0].shape))
        try:
            _region_parts(info, arrays, index)
        except (KeyError, ValueError) as e:
            raise type(e)(f"checkpoint step {step}: {key}: {e}") from e
        plans[key] = (info, leaf, placement, index)
    out = {key: _restore_leaf(arrays, *plan) for key, plan in plans.items()}
    return _unflatten_like(target, out)


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def _open_shards(path: Path) -> dict[str, np.ndarray]:
    """{file key: array} of one ``.npz`` shard file.  A member stored
    uncompressed (as ``np.savez`` stores) is memory-mapped where it lies
    in the file, so a restore reads only the pages its shards need, at
    the page cache's speed; any other member is read whole."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for member in zf.infolist():
            key = member.filename.removesuffix(".npy")
            header = None
            if member.compress_type == zipfile.ZIP_STORED:
                raw.seek(member.header_offset)
                head = raw.read(30)          # the local file header
                n_name, n_extra = struct.unpack("<HH", head[26:30])
                raw.seek(member.header_offset + 30 + n_name + n_extra)
                reader = _HEADER_READERS.get(np.lib.format.read_magic(raw))
                header = reader(raw) if reader else None
            if header is None or math.prod(header[0]) == 0 or \
                    header[2].hasobject:
                with zf.open(member) as f:
                    out[key] = np.lib.format.read_array(f)
                continue
            shape, fortran, dtype = header
            out[key] = np.memmap(path, dtype=dtype, mode="c",
                                 offset=raw.tell(), shape=shape,
                                 order="F" if fortran else "C")
    return out


def _is_named(x) -> bool:
    from ..distributed.sharding import NamedSharding
    return isinstance(x, NamedSharding) or x is None


def _check_leaf(step: int, key: str, info: dict, leaf) -> None:
    want = _np_dtype(leaf.dtype)
    if tuple(info["shape"]) != tuple(leaf.shape) or \
            np.dtype(info["dtype"]) != want:
        raise ValueError(
            f"checkpoint step {step}: {key} is {info['dtype']}"
            f"{tuple(info['shape'])}, the target's {want}"
            f"{tuple(leaf.shape)}")


def _region_parts(info: dict, arrays: dict, index: list) -> list:
    """How the part ``index`` (``[[a, b], ...]``) of a checkpoint leaf is
    put together: ``[(file key, slices of the saved shard, slices of the
    part)]``, the slices None for a saved shard of exactly that index.
    Raises if a shard's array is missing or of another shape, or if the
    saved shards do not cover the part."""
    def saved_array(sh):
        data = arrays[sh["file_key"]]
        want = info["shape"] if sh["index"] is None else \
            [b - a for a, b in sh["index"]]
        if list(data.shape) != list(want):
            raise ValueError(f"shard {sh['file_key']!r} is "
                             f"{tuple(data.shape)}, its index {tuple(want)}")
        return data

    for sh in info["shards"]:
        if sh["index"] == index:
            saved_array(sh)
            return [(sh["file_key"], None, None)]
    parts, covered, done = [], 0, set()
    size = math.prod(b - a for a, b in index)
    for sh in info["shards"]:
        saved = sh["index"]
        if saved is None:                        # a host array, whole
            saved_array(sh)
            return [(sh["file_key"],
                     tuple(slice(a, b) for a, b in index), ...)]
        if json.dumps(saved) in done:            # a replica's copy
            continue
        done.add(json.dumps(saved))
        both = [(max(a, c), min(b, d))
                for (a, b), (c, d) in zip(index, saved)]
        if any(lo >= hi for lo, hi in both):
            continue
        saved_array(sh)
        parts.append((sh["file_key"],
                      tuple(slice(lo - c, hi - c) for (lo, hi), (c, _) in
                            zip(both, saved)),
                      tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in
                            zip(both, index))))
        covered += math.prod(hi - lo for lo, hi in both)
    if covered != size:
        raise ValueError(f"checkpoint shards cover {covered} of the "
                         f"{size} elements of {index}")
    return parts


def read_region(info: dict, arrays: dict, index: list) -> np.ndarray:
    """The part ``index`` (``[[a, b], ...]``) of a checkpoint leaf, put
    together from the saved shards that overlap it (``arrays`` maps each
    file key to its array); a saved shard of exactly that index is
    returned as it is."""
    parts = _region_parts(info, arrays, index)
    if parts[0][1] is None:
        return arrays[parts[0][0]]
    out = np.empty([b - a for a, b in index], np.dtype(info["dtype"]))
    for file_key, src, dst in parts:
        out[dst] = arrays[file_key][src]
    return out


def _placement(leaf, sharding):
    """The (device mesh, placements) a restored leaf takes, or None for a
    plain tensor written in place."""
    if sharding is not None:
        return sharding
    if _is_sharded(leaf):
        return leaf.device_mesh, tuple(leaf.placements)
    return None


def _restore_leaf(arrays: dict, info: dict, leaf, placement, index):
    """One leaf of ``restore_checkpoint``, once every leaf is checked."""
    local = torch.from_numpy(read_region(info, arrays, index))
    if placement is None:
        with torch.no_grad():
            leaf.copy_(local)
        return leaf
    mesh, pls = placement
    if _is_sharded(leaf) and leaf.device_mesh == mesh and \
            tuple(leaf.placements) == tuple(pls):
        with torch.no_grad():
            leaf.to_local().copy_(local)
        return leaf
    from torch.distributed.tensor import DTensor

    # A copy even on the CPU: the region may map the file.
    local = local.to(mesh.device_type, copy=True)
    shape = tuple(leaf.shape)
    return DTensor.from_local(local, mesh, pls, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _unflatten_like(target: Any, flat: dict, prefix: str = "") -> Any:
    """``target``'s nesting with the leaves of ``flat`` (keyed as
    ``flatten_tree`` keys them)."""
    if isinstance(target, dict):
        items = target.items()
    elif isinstance(target, (list, tuple)):
        items = enumerate(target)
    else:
        return flat[prefix]
    out = {k: _unflatten_like(v, flat, f"{prefix}{SEP}{k}" if prefix
                              else str(k)) for k, v in items}
    return out if isinstance(target, dict) else type(target)(out.values())


def cleanup_old(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(d.name.split("_")[1])
                   for d in ckpt_dir.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)
