"""Dry run of the distribution: does every cell's sharded state exist,
and how much of each device does it take?

For every (architecture × input shape × mesh) cell, on the production
meshes (single-pod 16 data × 16 model = 256 devices, multi-pod 2 × 256),
the cell's lowering (``configs.common``) gives its arguments as ``meta``
tensors and their PartitionSpec trees; ``sanitize_specs`` makes the
specs legal on the mesh, and each argument's bytes per device follow:
a leaf's bytes over the product of the sizes of the mesh axes its spec
shards it on.  Nothing is allocated, and no device or process group is
needed.

The JAX package's dry run compiles each cell with XLA and also reads the
compiled program's cost (FLOPs, bytes accessed), collective bytes,
temporary, output, alias and code bytes and compile time.  PyTorch has
no compiled whole-program HLO to read those from, so the records carry
the JAX keys that apply: ``arch``, ``shape``, ``mesh``, ``n_devices``,
``kind``, ``correction``, ``ok``, ``lower_s`` (the seconds to build the
lowering) and ``memory.argument_bytes``.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out results.json] [--resume]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

from ..configs import ARCH_IDS, all_cells, get_arch
from ..distributed.sharding import (axis_sizes, entry_axes, is_spec_leaf,
                                    sanitize_specs, tree_map)
from ..train.checkpoint import flatten_tree
from .mesh import make_production_mesh


def _leaf_bytes(spec, leaf, sizes: dict) -> int:
    """A leaf's bytes on one device under its sanitized ``spec``."""
    n = leaf.numel() * leaf.element_size()
    parts = math.prod(sizes[a] for d in (spec or ()) for a in entry_axes(d))
    if n % parts:
        raise ValueError(f"{n} bytes do not split {parts} ways")
    return n // parts


def argument_bytes(low, mesh) -> int:
    """The bytes of a lowering's arguments on each device of ``mesh``."""
    sizes = axis_sizes(mesh)
    total = 0
    for specs, args in zip(low.in_specs, low.args):
        specs = sanitize_specs(specs, args, mesh)
        per_leaf = tree_map(lambda s, a: _leaf_bytes(s, a, sizes), specs,
                            args, is_leaf=is_spec_leaf)
        total += sum(flatten_tree(per_leaf).values())
    return total


def run_cell(arch_id: str, shape: str, multi_pod: bool) -> dict:
    arch = get_arch(arch_id)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    low = arch.lowering(shape, mesh)
    arg_bytes = argument_bytes(low, mesh)
    return {
        "arch": arch_id, "shape": shape,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "n_devices": mesh.size,
        "kind": low.kind,
        "correction": arch.correction() if arch.correction else None,
        "ok": True,
        "lower_s": round(time.time() - t0, 3),
        "memory": {"argument_bytes": arg_bytes},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded in --out")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results: dict[str, dict] = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for aid, shape in cells:
        for mp in meshes:
            key = f"{aid}|{shape}|{'mp' if mp else 'sp'}"
            if args.resume and results.get(key, {}).get("ok"):
                print(f"[skip] {key}", flush=True)
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                rec = run_cell(aid, shape, mp)
                print(f"  ok: memory/dev: args="
                      f"{rec['memory']['argument_bytes'] / 2**30:.2f}GiB",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — recorded per cell
                rec = {"arch": aid, "shape": shape,
                       "mesh": "pod2x16x16" if mp else "pod16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
                print(f"  FAIL: {rec['error'][:200]}", flush=True)
            results[key] = rec
            out_path.write_text(json.dumps(results, indent=1))
    print(f"done: {len(cells) * len(meshes)} cells, {n_fail} failures",
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
