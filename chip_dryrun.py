#!/usr/bin/env python3
"""The dry run's trace of all 80 records, run on the host of the card's
machine (the card is not used), and the FLOPs of one cell by op.

    python3 chip_dryrun.py [--layers N] [--jobs J]
        [--breakdown ARCH:SHAPE[:LAYERS]]

Prints the card's name and power limit, then one JSON line: the seconds
of ``python -m repro_torch.launch.dryrun --all --both-meshes --cost``
(each decoder cut to ``--layers`` layers a layer group, or whole),
``--jobs`` cells at once, its records all ``ok``, the sum of their trace
seconds and the slowest, and for each family the record with the most
temporary bytes a device; then, with ``--breakdown``, the FLOPs a device
of that cell on (16, 16) (a decoder cut to LAYERS layers a group, or
whole), by op and the shapes of its tensor inputs.
The records go to ``chiprun_out/dryrun_cost.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def dry_run(layers: int | None, jobs: int) -> dict:
    out = ROOT / "chiprun_out" / "dryrun_cost.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
           "--both-meshes", "--cost", "--jobs", str(jobs), "--out", str(out)]
    if layers is not None:
        cmd += ["--layers", str(layers)]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                         text=True)
    wall = time.perf_counter() - t0
    if res.returncode:
        raise SystemExit(res.stdout[-3000:] + res.stderr[-3000:])
    recs = json.loads(out.read_text())
    assert len(recs) == 80 and all(r["ok"] for r in recs.values())

    from repro_torch.configs import get_arch

    most: dict = {}
    for key, r in recs.items():
        fam = get_arch(r["arch"]).family
        if r["memory"]["temp_bytes"] > most.get(fam, (0, ""))[0]:
            most[fam] = (r["memory"]["temp_bytes"], key)
    return {"layers": layers, "jobs": jobs, "seconds": wall,
            "records_ok": len(recs),
            "trace_s_sum": sum(r["compile_s"] for r in recs.values()),
            "slowest": sorted(((r["compile_s"], k) for k, r in recs.items()),
                              reverse=True)[:10],
            "most_temp_bytes_by_family": most}


def breakdown(cell: str) -> dict:
    """The FLOPs a device of ``cell`` (ARCH:SHAPE[:LAYERS]) on (16, 16),
    by (op, the shapes of its tensor inputs), the largest first."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import cost

    arch_id, shape, *cut = cell.split(":")
    layers = int(cut[0]) if cut else None
    by = collections.Counter()
    real = cost.CostMode.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = real(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            by[f"{func} {shapes}"] += self.flops - before
        return out

    cost.CostMode.__torch_dispatch__ = counted
    try:
        rec = cost.trace_cell(get_arch(arch_id, layers), shape, (16, 16))
    finally:
        cost.CostMode.__torch_dispatch__ = real
    return {"cell": cell, "layers": layers,
            "flops_per_device": rec["cost"]["flops_per_device"],
            "by_op": by.most_common()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--breakdown")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    print(card_line(), flush=True)
    row = {"torch": __import__("torch").__version__,
           "dryrun": dry_run(args.layers, args.jobs)}
    if args.breakdown:
        row["breakdown"] = breakdown(args.breakdown)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
