"""Atomic checkpoints in the JAX package's on-disk format.

Layout (one directory per step), as the JAX package's
``train.checkpoint`` writes it::

  ckpt_dir/
    step_000000123/
      manifest.json          # tree paths, shapes, dtypes, shard indices
      shard_h0.npz           # the arrays, keyed "<path>#<index>"
    LATEST                   # atomically updated pointer file

Keys are the JAX package's tree paths (``params/bags/tables``,
``opt/m/bot/layers/0/w``, ``opt/step``): the port's state is nested
dicts whose leaf keys already are those paths, so each package restores
the other's checkpoints.  One process writes whole arrays, so each
leaf's one shard index spans its full shape; a restore also accepts the
JAX package's sharded leaves (several index ranges) and its host-array
leaves (index ``null``).

``save_checkpoint`` copies the state to host memory before it returns
(the next step updates the tensors in place), and writes the files on a
thread unless ``blocking``.  A checkpoint becomes visible only when its
directory and then ``LATEST`` are renamed into place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

SEP = "/"
HOST = 0         # one process


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Nested dicts and lists → {path: leaf}, the path's parts joined by
    ``/`` (a list's parts are the indices)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{SEP}{k}" if prefix
                                 else str(k)))
    return flat


def tree_paths(tree: Any) -> list[str]:
    return list(flatten_tree(tree))


def _host_copy(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _index(shape) -> tuple[str, list]:
    full = [[0, int(d)] for d in shape]
    return "_".join(f"{a}-{b}" for a, b in full) or "scalar", full


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, state: Any,
                    blocking: bool = True) -> threading.Thread | None:
    """Write ``state`` (nested dicts of tensors or arrays) for ``step``.
    The host copy is taken before this returns; with ``blocking=False``
    the files are written on the returned thread."""
    ckpt_dir = Path(ckpt_dir)
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, leaf in flatten_tree(state).items():
        arr = _host_copy(leaf)
        tag, index = _index(arr.shape)
        arrays[f"{key}#{tag}"] = arr
        meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                     "shards": [{"index": index, "file_key": f"{key}#{tag}",
                                 "host": HOST}]}

    def write():
        step_dir = ckpt_dir / f"step_{step:09d}"
        tmp = ckpt_dir / f".tmp_step_{step:09d}_h{HOST}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard_h{HOST}.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "tree": meta, "n_hosts": 1,
             "time": time.time()}, indent=1))
        step_dir.mkdir(parents=True, exist_ok=True)
        for f in tmp.iterdir():
            os.replace(f, step_dir / f.name)
        tmp.rmdir()
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, ckpt_dir / "LATEST")   # atomic commit

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def load_arrays(ckpt_dir: str | os.PathLike, step: int) -> dict:
    """{path: full numpy array} of a checkpoint, its shards put
    together."""
    step_dir = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    payloads = {}
    for f in sorted(step_dir.glob("shard_h*.npz")):
        with np.load(f) as z:
            payloads.update({k: z[k] for k in z.files})
    out = {}
    for key, info in manifest["tree"].items():
        full = np.zeros(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
        for sh in info["shards"]:
            data = payloads[sh["file_key"]]
            if sh["index"] is None:
                full = data
            else:
                full[tuple(slice(a, b) for a, b in sh["index"])] = data
        out[key] = full
    return out


def restore_checkpoint(ckpt_dir: str | os.PathLike, step: int,
                       target: Any) -> Any:
    """Restore ``step`` into ``target`` (nested dicts of tensors, such as
    a train state) in place, and return it.  Every leaf of the target
    must be in the checkpoint with its shape and dtype; all of them are
    read before the first tensor is written."""
    arrays = load_arrays(ckpt_dir, step)
    flat = flatten_tree(target)
    for key, leaf in flat.items():
        if key not in arrays:
            raise KeyError(f"checkpoint step {step}: no leaf {key!r}")
        arr = arrays[key]
        want = torch.empty((), dtype=leaf.dtype).numpy().dtype
        if arr.shape != tuple(leaf.shape) or arr.dtype != want:
            raise ValueError(
                f"checkpoint step {step}: {key} is {arr.dtype}{arr.shape}, "
                f"the target's {want}{tuple(leaf.shape)}")
    with torch.no_grad():
        for key, leaf in flat.items():
            leaf.copy_(torch.from_numpy(arrays[key]))
    return target


def cleanup_old(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(d.name.split("_")[1])
                   for d in ckpt_dir.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)
