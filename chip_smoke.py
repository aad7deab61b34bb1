#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``
and then, printing one JSON line per phase:

1. build     — compiles the kernels; prints the build time and the card;
2. extract   — the main path at ECMWF's regular Gaussian F320 grid
               (640 × 1280) × ERA5's 37 pressure levels × 8 datetimes,
               float64 (1.94 GB on the card):
               ``PolytopeExtractor(cube, device_planner=True,
               burst_gather=True)`` on country, seam-box and
               all-levels requests; plans must equal the host
               ``Slicer``'s and values ``flat[plan.offsets]``, byte for
               byte, and every request must launch the planning kernel;
3. serve     — ``ExtractionService(cube).submit_batch`` over 64
               Zipf-drawn requests with the payload on the card;
4. kernels   — holds each kernel byte for byte against its plain
               PyTorch version on the card, on the inputs the main path
               gave it: gather_runs on every burst chunk lattice of phase
               2 (and on windows past the end of the payload),
               gather_rows on every compaction of phase 2 and every
               union read and per-request slice of phase 3, plan_runs_2d
               on the jobs of the country, seam and all-levels requests
               in float64 and float32;
5. timing    — each kernel at the main path's shapes, with CUDA events:
               kernel, plain version, one library call where one
               computes the same function, and the card's bound;
6. the kernels line, with the launch counts of phases 2-3.

The launch counters are reset just before phase 2 and read just after
phase 3, so the counts show that the main path ran through the kernels.
The last line is ``{"ok": true, "device": {...}}``; any failure raises
and the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP64_FLOPS = 34e12             # H100 SXM data sheet, FP64 outside tensor cores
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: gathered bytes start cold


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def bytes_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or tuple(a.shape) != tuple(b.shape):
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own pair of CUDA events after an L2 flush."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def zipf_draw(rng, n_items: int, n_draws: int, s: float = 1.1):
    import numpy as np

    w = 1.0 / np.arange(1, n_items + 1) ** s
    return rng.choice(n_items, size=n_draws, p=w / w.sum())


def plan_flops(verts, valid, sv0, eps0, tol_rel, n1) -> int:
    """Floating-point operations plan_runs_2d does on these jobs: per
    live (job, row), V distance tests, 5 per (below, above) pair lerp,
    and 3 binary searches over the minor axis."""
    import numpy as np

    total = 0
    log_n1 = int(np.ceil(np.log2(n1 + 1)))
    for j in range(verts.shape[0]):
        m = valid[j]
        x, v = verts[j, m, 0], int(m.sum())
        i0 = np.searchsorted(sv0, x.min() - eps0, side="left")
        i1 = np.searchsorted(sv0, x.max() + eps0, side="right")
        if i1 <= i0:
            continue
        tol = tol_rel * max(1.0, float(np.abs(x).max()))
        d = x[None, :] - sv0[i0:i1, None]
        pairs = ((d < -tol).sum(1) * ((d > tol).sum(1))).sum()
        total += int(pairs) * 5 + int(i1 - i0) * (3 * v + 3 * log_n1)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.analysis.plan_check import verify_plan
    from repro_torch.carry import payload_to_tensor
    from repro_torch.core import (DevicePlanner, PolytopeExtractor, Request,
                                  Slicer, Span)
    from repro_torch.dataplane.weather import (COUNTRIES,
                                               IrregularWeatherCube)
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.gather import kernel as gk, ops as gops
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.kernels.plan import kernel as pk, ref as pref
    from repro_torch.serve import ExtractionService

    class RecordingPlanner(DevicePlanner):
        """Records the pipeline inputs of every plan() call, so the
        kernel checks and timings see the tensors the main path hands
        the planning kernel."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []

        def _invoke(self, verts, valid, bases, scalars, g, max_rows):
            self.calls.append((verts, valid, bases, scalars, g, max_rows))
            return super()._invoke(verts, valid, bases, scalars, g,
                                   max_rows)

    dev = torch.device("cuda")
    card = card_line()

    def i32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library("gather")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- the cube, the payload and the requests -------------------------
    iwc = IrregularWeatherCube(n_dates=2, times_per_day=4, n_levels=37,
                               n_lat=640, n_lon=1280)
    cube = iwc.cube
    t0 = time.perf_counter()
    flat_np = iwc.field_data(seed=args.seed)
    flat = payload_to_tensor(flat_np, dev)
    torch.cuda.synchronize()
    dt_max = float(iwc.datetime_values[-1])
    requests = {c: iwc.country_request(c) for c in COUNTRIES}
    requests["seam_box"] = iwc.seam_box_request(35.0, 62.0, -20.0, 20.0)
    requests["germany_all_levels"] = Request([
        Span("datetime", 0.0, dt_max),
        Span("level", 0.0, float(iwc.n_levels - 1)),
        iwc.country_request("germany").shapes[2]])
    emit({"phase": "payload", "elements": cube.n_elements,
          "bytes": int(flat.numel() * flat.element_size()),
          "seconds": time.perf_counter() - t0})

    # -- 2. the main path: device planning + burst gather ---------------
    reset_launches()
    pe = PolytopeExtractor(cube, device_planner=True, burst_gather=True)
    host = Slicer(cube)
    rows = []
    # What gather_plan_runs hands B2 and B1 for each request's plan.
    burst_inputs = {}
    for name, req in requests.items():
        before = LAUNCHES["plan_runs_2d"]
        t0 = time.perf_counter()
        res = pe.extract(req, flat)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        assert LAUNCHES["plan_runs_2d"] == before + 1, \
            f"{name}: the device planner fell back to the host"
        t0 = time.perf_counter()
        hplan, hstats = host.extract_plan(req)
        host_s = time.perf_counter() - t0
        plan, stats = res.plan, res.stats
        assert np.array_equal(plan.offsets, hplan.offsets), name
        assert np.array_equal(plan.run_starts, hplan.run_starts), name
        assert np.array_equal(plan.run_lengths, hplan.run_lengths), name
        assert stats.n_slices_by_dim == hstats.n_slices_by_dim, name
        verify_plan(plan, datacube=cube, stats=stats)
        want = torch.from_numpy(flat_np[hplan.offsets])
        assert res.values.is_cuda and bytes_equal(res.values.cpu(), want), \
            f"{name}: values != flat[plan.offsets]"
        burst_inputs[name] = gops.chunk_runs(plan.run_starts,
                                             plan.run_lengths)
        rows.append({"request": name, "points": int(plan.n_points),
                     "runs": int(len(plan.run_starts)),
                     "extract_s": dev_s, "host_plan_s": host_s})
    emit({"phase": "extract", "requests": rows})

    # -- 3. serving: Zipf-drawn batches over the card-resident payload --
    population = list(requests.values())
    for name in COUNTRIES:       # drifted repeats: next datetime / level
        population.append(iwc.country_request(name, datetime=21600.0))
        population.append(iwc.country_request(name, level=1.0))
    rng = np.random.default_rng(args.seed)
    draws = zipf_draw(rng, len(population), 64)
    svc = ExtractionService(cube)
    host_plans = {}
    # What shared_union_gather hands B1 for each batch: the union read's
    # offsets and each distinct plan's positions in the union buffer.
    union_reads = []
    for b in range(4):
        batch = [population[i] for i in draws[16 * b:16 * (b + 1)]]
        results = svc.submit_batch(batch, flat)
        torch.cuda.synchronize()
        for res in results:
            if res.key not in host_plans:
                host_plans[res.key] = host.extract_plan(res.request)[0]
            hplan = host_plans[res.key]
            assert np.array_equal(res.plan.offsets, hplan.offsets)
            want = torch.from_numpy(flat_np[hplan.offsets])
            assert res.values.is_cuda and bytes_equal(res.values.cpu(),
                                                      want)
        plans = {r.key: r.plan for r in results if r.plan.n_points}
        union = np.unique(np.concatenate(
            [p.offsets for p in plans.values()]))
        union_reads.append((union, [np.searchsorted(union, p.offsets)
                                    for p in plans.values()]))
    st = svc.stats
    emit({"phase": "serve", "requests": 64, "batches": 4, "hits": st.hits,
          "misses": st.misses, "delta_hits": st.delta_hits,
          "batch_dedup": st.batch_dedup,
          "bytes_requested": st.bytes_requested,
          "bytes_read": st.bytes_read})
    launches = dict(LAUNCHES)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"

    # -- 4. kernels against their plain versions, on main-path inputs ---
    errs = {"gather_rows": 0.0, "gather_runs": 0.0, "plan_runs_2d": 0.0}
    n_checked = {k: 0 for k in errs}

    def check(kname, got, want, what):
        assert bytes_equal(got, want), f"{kname} != plain version ({what})"
        errs[kname] = max(errs[kname], max_abs_err(got, want))
        n_checked[kname] += 1

    blk = gops.BURST_BLOCK
    for name, (cs_np, gidx_np) in burst_inputs.items():
        cs = i32(cs_np)
        lattice = gk.gather_runs(flat, cs, blk)
        check("gather_runs", lattice, gref.gather_runs(flat, cs, blk), name)
        lat, gi = lattice.reshape(-1, 1), i32(gidx_np)
        check("gather_rows", gk.gather_rows(lat, gi),
              gref.gather_rows(lat, gi), f"{name} compaction")
    n = flat.numel()
    tail = i32([n - 1, n - 60, n - blk + 1, 0])   # windows past the end
    got = gk.gather_runs(flat, tail, blk)
    check("gather_runs", got, gref.gather_runs(flat, tail, blk), "tail")
    assert not bool(got[0, 1:].any()), "gather_runs read past the end"

    table = flat[:, None]
    for b, (union, positions) in enumerate(union_reads):
        u = i32(union)
        buf = gk.gather_rows(table, u)
        check("gather_rows", buf, gref.gather_rows(table, u),
              f"batch {b} union read")
        for pos in positions:
            p = i32(pos)
            check("gather_rows", gk.gather_rows(buf, p),
                  gref.gather_rows(buf, p), f"batch {b} slice")

    recs = {}
    for dtype in (np.float64, np.float32):
        rec = recs[dtype] = RecordingPlanner(cube, dtype=dtype)
        for name in ("germany", "uk", "seam_box", "germany_all_levels"):
            assert rec.plan(requests[name]) is not None, name
        for verts, valid, bases, scalars, g, max_rows in rec.calls:
            tens = rec.pipeline_inputs(verts, valid, bases, scalars, g)
            kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows,
                      cyclic=g["cyclic"])
            got = pk.plan_runs_2d(*tens, **kw)
            want = pref.plan_runs_2d(*tens, **kw)
            for a, b in zip(got, want):
                check("plan_runs_2d", a, b, np.dtype(dtype).name)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "byte_equal": True, "checked": n_checked,
          "max_abs_err": errs})

    # -- 5. timing at the main path's shapes ----------------------------
    timer = Timer(dev)
    entries = []

    # B1: the last batch's union read (D = 1).
    idx = i32(union_reads[-1][0])
    m = idx.numel()
    b1_bytes = m * (8 + 4 + 8)
    entries.append({
        "name": "gather_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:71",
        "launches": launches["gather_rows"],
        "max_abs_err": errs["gather_rows"],
        "ms": timer(lambda: gk.gather_rows(table, idx)),
        "plain_ms": timer(lambda: gref.gather_rows(table, idx)),
        "bound_ms": b1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.index_select(flat, 0, idx)),
        "shape": {"M": m, "D": 1}})

    # B2: the all-levels request's burst chunks.
    cs = i32(burst_inputs["germany_all_levels"][0])
    c = cs.numel()
    window = (cs.long()[:, None] + torch.arange(blk, device=dev)).clamp(
        max=flat.numel() - 1).reshape(-1)
    b2_bytes = c * (blk * 8 + 4 + blk * 8)
    entries.append({
        "name": "gather_runs", "route": "cuda",
        "source": "src/repro_torch/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather/kernel.py:181",
        "launches": launches["gather_runs"],
        "max_abs_err": errs["gather_runs"],
        "ms": timer(lambda: gk.gather_runs(flat, cs, blk)),
        "plain_ms": timer(lambda: gref.gather_runs(flat, cs, blk)),
        "bound_ms": b2_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": timer(lambda: torch.index_select(flat, 0, window)),
        "shape": {"C": c, "block": blk}})

    # B3: the all-levels request's jobs, float64.
    rec = recs[np.float64]
    verts, valid, bases, scalars, g, max_rows = rec.calls[-1]
    tens = rec.pipeline_inputs(verts, valid, bases, scalars, g)
    kw = dict(n0=g["n0"], n1=g["n1"], max_rows=max_rows, cyclic=g["cyclic"])
    n_slots = verts.shape[0] * max_rows * 2
    b3_bytes = sum(t.numel() * t.element_size() for t in tens) \
        + 2 * n_slots * 4 + 3 * 4
    b3_flops = plan_flops(verts, valid, g["sv0"], g["eps0"], scalars[2],
                          g["n1"])
    t_bytes = b3_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = b3_flops / FP64_FLOPS * 1e3
    entries.append({
        "name": "plan_runs_2d", "route": "cuda",
        "source": "src/repro_torch/csrc/plan_runs_2d.cu",
        "replaces": "src/repro/kernels/plan/kernel.py:86",
        "launches": launches["plan_runs_2d"],
        "max_abs_err": errs["plan_runs_2d"],
        "ms": timer(lambda: pk.plan_runs_2d(*tens, **kw)),
        "plain_ms": timer(lambda: pref.plan_runs_2d(*tens, **kw)),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": None,
        "shape": {"J": int(verts.shape[0]), "V": int(verts.shape[1]),
                  "max_rows": int(max_rows), "n0": g["n0"], "n1": g["n1"],
                  "flops": b3_flops, "bytes": b3_bytes}})
    emit({"phase": "timing", "card": card})

    # -- 6. the kernels line, the card, the result -----------------------
    emit({"kernels": entries, "launches": launches})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
