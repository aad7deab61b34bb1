"""Dry run of the distribution: does every cell's sharded state exist,
how much of each device does it take, and, with ``--cost``, what does
one device do in the cell's step?

For every (architecture × input shape × mesh) cell, on the production
meshes (single-pod 16 data × 16 model = 256 devices, multi-pod 2 × 256),
the cell's lowering (``configs.common``) gives its arguments as ``meta``
tensors and their PartitionSpec trees; ``sanitize_specs`` makes the
specs legal on the mesh, and each argument's bytes per device follow:
a leaf's bytes over the product of the sizes of the mesh axes its spec
shards it on.  Nothing is allocated, and no device or process group is
needed.  The record holds the JAX dry run's keys: ``arch``, ``shape``,
``mesh``, ``n_devices``, ``kind``, ``probe`` (``None``: the port has no
cost probes), ``correction``, ``ok``, ``lower_s`` (the seconds to build
the lowering) and ``memory.argument_bytes``.

With ``--cost`` each cell is also traced (``launch.cost.trace_cell``):
its ``fn`` runs once on fake tensors as rank 0 of a fake process group
of the mesh's size, and the record gains the JAX dry run's other keys,
for that one device:
- ``cost.flops_per_device``: ``FlopCounterMode``'s formulas over the
  device's own ops, the port's custom ops (B1, B6, B7) by their own
  formulas.  Elementwise FLOPs are not counted (``FlopCounterMode`` has
  no formula for them; XLA's ``cost_analysis`` counts them).
- ``cost.bytes_accessed_per_device``: the input and output bytes of each
  of those ops that moves data (views excluded).
- ``collectives``: bytes and count of each of the five kinds of
  ``collective_bytes``, each collective's result bytes, and
  ``total_bytes``.
- ``memory.output_bytes``, ``alias_bytes`` (outputs that share storage
  with the donated arguments), ``temp_bytes`` (the peak of live storage
  bytes less the arguments and the non-aliased outputs) and
  ``code_bytes``, ``None``: the port compiles no whole program.
- ``compile_s``: the trace's seconds.
The trace runs every layer and every microbatch, so the port needs no
cost probes.  ``--layers N`` cuts each decoder's layer groups to at
most N layers first (``configs.common.cut_layers``; recorded as
``layers``), for a quick run; the other families are traced whole.
``--jobs`` runs that many cells at once, each in a process of its own.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--cost [--layers N] [--jobs J]] [--out results.json] [--resume]
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


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch_id: str, shape: str, multi_pod: bool, cost: bool = False,
             layers: int | None = None) -> dict:
    """The cell's record on a production mesh; with ``cost``, traced
    (``layers``: a decoder cut to at most that many layers a group)."""
    arch = get_arch(arch_id, layers)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    low = arch.lowering(shape, mesh)
    arg_bytes = argument_bytes(low, mesh)
    rec = {
        "arch": arch_id, "shape": shape, "mesh": _mesh_name(multi_pod),
        "n_devices": mesh.size,
        "kind": low.kind,
        "probe": None,
        "correction": arch.correction() if arch.correction else None,
        "ok": True,
        "lower_s": round(time.time() - t0, 3),
        "memory": {"argument_bytes": arg_bytes},
    }
    if not cost:
        return rec
    from .cost import trace_cell

    traced = trace_cell(arch, shape, mesh.axis_sizes)
    if traced["memory"]["argument_bytes"] != arg_bytes:
        raise AssertionError(
            f"the trace's arguments take {traced['memory']['argument_bytes']}"
            f" bytes a device, the lowering's {arg_bytes}")
    rec.update(compile_s=round(traced["seconds"], 3),
               memory=traced["memory"], cost=traced["cost"],
               collectives=traced["collectives"])
    if layers is not None and arch.family == "lm":
        rec["layers"] = layers
    return rec


def _failed(aid: str, shape: str, mp: bool, e: BaseException) -> dict:
    return {"arch": aid, "shape": shape, "mesh": _mesh_name(mp),
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def _one(job: tuple) -> tuple[str, dict]:
    """(key, record) of one cell; a failure is recorded, not raised."""
    key, aid, shape, mp, cost, layers = job
    try:
        return key, run_cell(aid, shape, mp, cost, layers)
    except Exception as e:  # noqa: BLE001 — recorded per cell
        return key, _failed(aid, shape, mp, e)


def _one_thread() -> None:
    """A worker's setting: one thread of its own (a trace dispatches
    ops on fake tensors; more threads only contend with the others)."""
    import torch

    torch.set_num_threads(1)


def _report(key: str, rec: dict) -> None:
    if not rec["ok"]:
        print(f"  FAIL {key}: {rec['error'][:200]}", flush=True)
        return
    line = f"  ok {key}: memory/dev: args=" \
        f"{rec['memory']['argument_bytes'] / 2**30:.2f}GiB"
    if "cost" in rec:
        line += (f" temp={rec['memory']['temp_bytes'] / 2**30:.2f}GiB "
                 f"flops/dev={rec['cost']['flops_per_device']:.3e} "
                 f"coll={rec['collectives']['total_bytes']:.3e}B "
                 f"trace={rec['compile_s']}s")
    print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cost", action="store_true",
                    help="trace each cell on fake tensors: FLOPs, bytes "
                         "accessed, collectives, temporary, output and "
                         "alias bytes per device")
    ap.add_argument("--layers", type=int,
                    help="with --cost: cut each decoder's layer groups to "
                         "at most this many layers")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded in --out")
    args = ap.parse_args(argv)
    if args.layers is not None and not args.cost:
        ap.error("--layers cuts the trace: it needs --cost")

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
    t0 = time.time()
    jobs = []
    for aid, shape in cells:
        for mp in meshes:
            key = f"{aid}|{shape}|{'mp' if mp else 'sp'}"
            if args.resume and results.get(key, {}).get("ok"):
                print(f"[skip] {key}", flush=True)
                continue
            jobs.append((key, aid, shape, mp, args.cost, args.layers))
            print(f"[dryrun] {key} ...", flush=True)

    def record(key: str, rec: dict) -> None:
        _report(key, rec)
        results[key] = rec
        out_path.write_text(json.dumps(results, indent=1))

    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                 initializer=_one_thread) as pool:
            for done in as_completed([pool.submit(_one, j) for j in jobs]):
                record(*done.result())
    else:
        for job in jobs:
            record(*_one(job))
    n_fail = sum(not results[j[0]]["ok"] for j in jobs)
    print(f"done: {len(cells) * len(meshes)} cells, {n_fail} failures, "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
