#!/usr/bin/env python3
"""B1, B3, B5, B6, the batched crop planner and the extraction read of
one source tree of the port, timed on one card, for a comparison of two
trees within one call.

    python3 chip_ab.py [--src DIR]

DIR is the ``src`` directory of a checkout of the port (this checkout's
by default; an unpacked parent's for the comparison).  The script
imports ``repro_torch`` from DIR, so the kernels are built from DIR's
``csrc`` into that checkout's ``build/``; the inputs and the measurement
are ``chip_smoke.py``'s, for both trees:

* B3 on the device planner's inputs for ``chip_smoke.weather_setup``'s
  Germany and Germany over all datetimes and levels (3552 jobs), float64:
  ``chip_smoke.b3_timing`` (the call's time with CUDA events after an L2
  flush, the device time of each kernel and memset by
  ``torch.profiler``), each call byte for byte against the plain
  version, and the planner's ``plan()`` wall time (median of 5: the
  kernel, the copy back and the host's expansion of the runs);
* B6 at phase 8's bulk calls: each of ``chip_smoke.recsys_models`` drawn
  on the card from ``chip_smoke.py``'s default seed, its bulk batch
  (``chip_smoke.recsys_batches``) run once and its B6 calls recorded:
  DLRM-RM2's (D = 64, and its ids padded to L = 8) and DeepFM's (D = 10
  and D = 1), each byte for byte against the plain version, and timed by
  ``chip_smoke.b6_bulk_timings`` (the kernel, its plain version, the
  bound, the sector floor and ``F.embedding_bag``);
* the extraction read through entry points that both trees have, on
  the F320 payload of ``chip_smoke.py``'s default seed:
  ``ops.gather_plan_runs`` on the all-levels request's plan (the host's
  work on the runs, the uploads and every launch) and
  ``serve.shared_union_gather`` on ``chip_smoke.serve_windows``' last
  window (its union, the slices, the uploads and every launch), each
  checked against the payload read on the host: the median host-clock
  time of 30 calls, each ending in a synchronize, and the device time
  of one call by kernel and copy (``chip_smoke.kernel_breakdown``);
* ``batched``: ``core.batched.batched_plan_2d`` and
  ``batched_extract_2d`` at phase 6's inputs (``chip_smoke.batched_crops``:
  256 crops on one F320 field, the vertices and the field on the card,
  the axes as numpy arrays), each checked byte for byte against the same
  call with ``device="cpu"``: the median host-clock time of 30 calls,
  each ending in a synchronize, and the device time of one call by
  kernel and copy;
* ``b1``: B1 through ``ops.gather_rows`` (an entry point both trees
  have) at the plain extract's read (the all-levels plan's 174,640
  offsets into the F320 payload, as numpy) and at two-tower's
  ``retrieval_cand`` lookup (``chip_smoke.b1_candidate_case``: 2^20 ids
  on the card into 10^6 rows of 1 KB), each checked against the payload
  read on the host, timed as ``read`` is, with B1's kernel alone under
  ``b1_kernel_ms``;
* ``bfs``: B5 (``slice_batch``) at phase 5's layer
  (``chip_smoke.bfs_layer``, packed on the card), checked against its
  plain version, timed the same way.

Prints the card (``nvidia-smi``) and then one JSON line.  Compare trees
only within one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import chip_smoke

HERE = Path(__file__).resolve().parent
SEED = 0        # chip_smoke.py's default --seed: the same tables and bags


def b3(dev) -> dict:
    import numpy as np

    from repro_torch.kernels.plan import kernel as pk
    from repro_torch.kernels.plan import ref as pref

    iwc, requests = chip_smoke.weather_setup()
    planner = chip_smoke.recording_planner(iwc.cube, device=dev,
                                           dtype=np.float64)
    timer = chip_smoke.Timer(dev)
    out = {}
    for name in ("germany", "germany_all_levels"):
        plan_s = []
        for _ in range(6):                 # the first call is a warm-up
            t0 = time.perf_counter()
            assert planner.plan(requests[name]) is not None, name
            plan_s.append(time.perf_counter() - t0)
        verts, valid, bases, scalars, g, max_rows = planner.calls[-1]
        tens = planner.pipeline_inputs(verts, valid, bases, scalars, g)
        kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows,
                  cyclic=g["cyclic"])
        for got, want in zip(pk.plan_runs_2d(*tens, **kw),
                             pref.plan_runs_2d(*tens, **kw)):
            assert chip_smoke.bytes_equal(got, want), name
        out[name] = {**chip_smoke.b3_timing(timer, planner,
                                            planner.calls[-1]),
                     "plan_s_median": statistics.median(plan_s[1:])}
    return out


def b6(dev) -> list:
    import torch

    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    def check(kname, got, want, what):
        assert chip_smoke.bytes_equal(got, want), f"{kname}: {what}"

    out = []
    for kind, cfg, cls in chip_smoke.recsys_models():
        with torch.no_grad():
            model = cls(cfg, device=dev, seed=SEED)
            bulk = chip_smoke.recsys_batches(cfg, retrieval=False)[-1]
            with chip_smoke.recording(gk, "gather_rows_bag") as calls:
                model(*chip_smoke.recsys_inputs(model, bulk, dev))
        bulk_calls = [a for a, _ in calls]
        for a in bulk_calls:
            check("gather_rows_bag", gk.gather_rows_bag(*a),
                  gref.gather_rows_bag(*a), f"{kind} bulk")
        out += chip_smoke.b6_bulk_timings(dev, SEED, cfg.name, bulk_calls,
                                          check, padded=kind == "dlrm")
        del model, calls, bulk_calls
        torch.cuda.empty_cache()        # the model is gone: free its tables
    return out


def host_and_device(fn) -> dict:
    """The median host-clock time of 30 calls of ``fn`` (after one
    warm-up), each ending in a synchronize, and the device time of one
    call by kernel and copy."""
    import torch

    wall = []
    for _ in range(31):                    # the first call is a warm-up
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return {"host_ms_median": statistics.median(wall[1:]) * 1e3,
            **chip_smoke.kernel_breakdown(fn)}


def batched(dev, iwc, requests, flat_np) -> dict:
    import torch

    from repro_torch.core import batched as core_batched
    from repro_torch.kernels.slice import ops as sops

    bc = chip_smoke.batched_crops(iwc, requests, flat_np, SEED)
    verts, valid = sops.pack_polytopes(bc["crops"], device=dev)
    field = torch.from_numpy(bc["field"]).to(dev)
    grid = (bc["n0"], bc["n1"])
    size = (bc["max_rows"], bc["max_cols"])
    calls = {
        "batched_plan_2d": lambda d, f, v, m: core_batched.batched_plan_2d(
            v, m, bc["axis0"], bc["axis1"], *grid, *size, device=d),
        "batched_extract_2d": lambda d, f, v, m:
            core_batched.batched_extract_2d(f, v, m, bc["axis0"],
                                            bc["axis1"], *size, device=d),
    }
    out = {"shape": {"P": len(bc["crops"]), "R": size[0], "C": size[1],
                     "n0": grid[0], "n1": grid[1]}}
    for name, call in calls.items():
        plain = call("cpu", field.cpu(), verts.cpu(), valid.cpu())
        for a, b in zip(call(dev, field, verts, valid), plain):
            assert chip_smoke.bytes_equal(a.cpu(), b), name
        out[name] = host_and_device(lambda: call(dev, field, verts, valid))
    return out


def bfs(dev, iwc, requests) -> dict:
    import torch

    from repro_torch.kernels.slice import ops as sops
    from repro_torch.kernels.slice import ref as sref

    layer, _, planes = chip_smoke.bfs_layer(iwc, requests)
    verts, valid = sops.pack_polytopes([p for p, _ in layer], device=dev)
    planes = torch.from_numpy(planes).to(dev)
    for a, b in zip(sops.slice_batch(verts, valid, planes, 0),
                    sref.slice_batch(verts, valid, planes, 0)):
        assert chip_smoke.bytes_equal(a, b), "slice_batch"
    return {"shape": {"P": int(verts.shape[0]), "V": int(verts.shape[1]),
                      "D": int(verts.shape[2])},
            "slice_batch": host_and_device(
                lambda: sops.slice_batch(verts, valid, planes, 0))}


def read(dev, iwc, requests, flat_np) -> dict:
    import numpy as np
    import torch

    from repro_torch.carry import payload_to_tensor
    from repro_torch.core import Slicer
    from repro_torch.kernels.gather import ops as gops
    from repro_torch.serve import ExtractionService, shared_union_gather

    flat = payload_to_tensor(flat_np, dev)
    plan = Slicer(iwc.cube).extract_plan(requests["germany_all_levels"])[0]
    window = chip_smoke.serve_windows(iwc, requests, SEED)[-1]
    svc = ExtractionService(iwc.cube, device=dev)
    results = svc.submit_batch(window)            # plans only
    batch_plans = {r.key: r.plan for r in results}

    def burst():
        return gops.gather_plan_runs(flat, plan.run_starts, plan.run_lengths)

    def serve():
        shared_union_gather(iwc.cube, results, batch_plans, flat)

    assert chip_smoke.bytes_equal(burst().cpu(), torch.from_numpy(
        flat_np[plan.offsets])), "burst read"
    serve()
    for r in results:
        assert chip_smoke.bytes_equal(r.values.cpu(), torch.from_numpy(
            flat_np[r.plan.offsets])), "window read"
    out = {name: host_and_device(fn) for name, fn in
           (("gather_plan_runs", burst), ("union_read", serve))}
    union = np.unique(np.concatenate([p.offsets for p in
                                      batch_plans.values()]))
    out["shape"] = {"N": int(plan.n_points), "R": int(len(plan.run_starts)),
                    "window_plans": len(batch_plans),
                    "window_points": int(sum(p.n_points for p in
                                             batch_plans.values())),
                    "union": int(union.size)}
    del flat
    torch.cuda.empty_cache()
    return out


def b1(dev, iwc, requests, flat_np) -> dict:
    """B1 through ``ops.gather_rows``: the plain extract's read (the
    all-levels plan's offsets as numpy, into the payload as a (n, 1)
    table) and two-tower's ``retrieval_cand`` lookup (1 KB rows, M = 2^20,
    the ids on the card; ``chip_smoke.b1_candidate_case``), each checked
    against the payload read on the host; the host-clock median and the
    device time by kernel and copy, with B1's own kernel under
    ``b1_kernel_ms``."""
    import torch

    from repro_torch.carry import payload_to_tensor
    from repro_torch.core import Slicer
    from repro_torch.kernels.gather import ops as gops

    def timed(fn) -> dict:
        row = host_and_device(fn)
        row["b1_kernel_ms"] = sum(k["ms"] * round(k["per_call"])
                                  for k in row["kernels"]
                                  if "gather_rows_kernel" in k["name"])
        return row

    flat = payload_to_tensor(flat_np, dev)
    plan = Slicer(iwc.cube).extract_plan(requests["germany_all_levels"])[0]

    def extract():
        return gops.gather_rows(flat[:, None], plan.offsets)

    assert chip_smoke.bytes_equal(extract()[:, 0].cpu(), torch.from_numpy(
        flat_np[plan.offsets])), "plain extract read"
    out = {"plain_extract": {**timed(extract),
                             "shape": {"M": int(plan.n_points), "D": 1}}}
    del flat
    table, idx = chip_smoke.b1_candidate_case(dev, SEED)

    def lookup():
        return gops.gather_rows(table, idx)

    assert chip_smoke.bytes_equal(lookup().cpu(),
                                  table.cpu()[idx.cpu().long()]), "1 KB rows"
    out["retrieval_cand"] = {**timed(lookup),
                             "shape": {"M": idx.numel(), "D": 256}}
    del table, idx
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=HERE / "src")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    # This tree's port first on the path, whatever chip_smoke put there.
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build

    assert Path(_build.__file__).resolve().is_relative_to(
        args.src.resolve()), _build.__file__
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library("gather")
    build_s = time.perf_counter() - t0
    card = chip_smoke.card_line()
    print(card, flush=True)
    iwc, requests = chip_smoke.weather_setup()
    flat_np = iwc.field_data(seed=SEED)
    chip_smoke.emit({"src": str(args.src), "card": card,
                     "build_s": build_s,
                     "batched": batched(dev, iwc, requests, flat_np),
                     "bfs": bfs(dev, iwc, requests),
                     "read": read(dev, iwc, requests, flat_np),
                     "b1": b1(dev, iwc, requests, flat_np),
                     "b3": b3(dev), "b6": b6(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
