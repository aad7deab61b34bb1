"""Domain-interface tour on the PyTorch port (paper §4), as
``examples/extract_weather.py``: every Table-1 request type against a
synthetic weather cube, printing the index-tree → plan → gather flow —
plus the irregular-datacube scenario (DESIGN.md §2.5): merged date/time,
mapped Gaussian latitudes, and a cross-seam UK crop on a cyclic
longitude, served through the plan cache with a seam-shifted cache hit.
Each payload goes to the device once: the regular cube's extracts plan
on the device where eligible and read their runs with the burst gather;
the irregular scenario's reads go through the extraction service (on the
card one union read with every request's slice a batch).  Writes
``BENCH_torch_extraction.json`` (or ``--out``) with the irregular
scenario's reduction factor, plan time, and bytes moved, in the schema
of the JAX package's ``BENCH_extraction.json``.

  PYTHONPATH=src python examples/torch_extract_weather.py         # the card
  PYTHONPATH=src python examples/torch_extract_weather.py --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.carry import payload_to_tensor
from repro_torch.core import (BoundingBoxExtractor, Box, PolytopeExtractor,
                              Request, Select, Slicer, TraditionalExtractor)
from repro_torch.dataplane.weather import (IrregularWeatherCube,
                                           WeatherCube, paris_newyork_path)
from repro_torch.serve.extraction import ExtractionService

GRID = dict(n=96, n_times=8, n_levels=10)
GRID_SEED = 7
IRREGULAR = dict(n_lat=160, n_lon=320)
IRREGULAR_SEED = 3
DEFAULT_OUT = "BENCH_torch_extraction.json"


def cubes_and_data() -> dict:
    """The example's two cubes with their flat payloads on the host:
    ``{"regular": (wc, data), "irregular": (iwc, data)}``."""
    wc = WeatherCube(**GRID)
    iwc = IrregularWeatherCube(**IRREGULAR)
    return {"regular": (wc, wc.field_data(seed=GRID_SEED)),
            "irregular": (iwc, iwc.field_data(seed=IRREGULAR_SEED))}


def regular_demos(wc: WeatherCube) -> dict:
    return {
        "Italy, t=2, level=0": wc.country_request("italy",
                                                  time=2 * 3600.0),
        "London time-series (all 8 steps)": wc.timeseries_request(
            51.5, 0.0, 0.0, 7 * 3600.0),
        "Rome vertical profile (10 levels)": wc.profile_request(
            41.9, 12.5),
        "Paris→NY flight tube": wc.flight_path_request(
            paris_newyork_path(wc), width=2.0),
    }


def irregular_scenarios(iwc: IrregularWeatherCube) -> dict:
    return {
        "uk_cross_seam_crop": iwc.country_request("uk"),
        "seam_box_-20_20": iwc.seam_box_request(40.0, 60.0, -20.0, 20.0),
        "timeseries_across_midnight": iwc.timeseries_request(
            51.5, 0.0, 43200.0, 86400.0 + 43200.0),
    }


def run_irregular(iwc, data: np.ndarray, dev, out_path: str) -> dict:
    print("— irregular datacube (merged datetime · mapped Gaussian lat · "
          "cyclic lon) —")
    payload = payload_to_tensor(data, dev)
    svc = ExtractionService(iwc.cube, device=dev)
    bb = BoundingBoxExtractor(iwc.cube)
    tr = TraditionalExtractor(iwc.cube, field_axes=("lat", "lon"))
    print(f"cube: {iwc.cube.n_elements:,} elements, logical axes "
          f"{iwc.cube.axis_names}, periods {iwc.cube.axis_periods()}\n")

    scenarios = irregular_scenarios(iwc)
    rows, values = [], {}
    for name, req in scenarios.items():
        res = svc.extract(req, payload)
        plan, stats = res.plan, res.stats
        values[name] = res.values.cpu().numpy()
        trad = tr.nbytes(req)
        box = bb.plan(req).nbytes
        rows.append(dict(
            example=name,
            polytope_bytes=int(plan.nbytes),
            bbox_bytes=int(box),
            traditional_bytes=int(trad),
            n_points=plan.n_points,
            n_runs=plan.n_runs,
            reduction_vs_traditional=trad / max(plan.nbytes, 1),
            reduction_vs_bbox=box / max(plan.nbytes, 1),
            plan_time_s=stats.total_time_s if stats else 0.0,
        ))
        print(f"{name}: {plan.n_points} points, {plan.nbytes:,} B in "
              f"{plan.n_runs} runs, reduction {trad / max(plan.nbytes, 1):,.0f}× "
              f"vs whole-field, values mean "
              f"{float(np.mean(values[name])):.2f}")

    # Seam-shifted re-request: same geometry expressed +360° away must
    # hit the plan cache (canonicalization modulo the period).
    shifted = Request([Select("datetime", [0.0]), Select("level", [0.0]),
                       Box(("lat", "lon"), [40.0, 340.0], [60.0, 380.0])])
    base = iwc.seam_box_request(40.0, 60.0, -20.0, 20.0)
    svc.extract(base)
    hit = svc.extract(shifted)
    print(f"seam-shifted box (+360°) served from cache: {hit.cached}\n")

    payload_json = {"bench": "extraction", "rows": rows,
                    "seam_shift_cache_hit": bool(hit.cached)}
    with open(out_path, "w") as fh:
        json.dump(payload_json, fh, indent=2)
    print(f"wrote {out_path}")
    return {"rows": rows, "seam_shift_cache_hit": bool(hit.cached),
            "requests": scenarios, "values": values}


def main(argv: list[str] | None = None) -> dict:
    """Print the tour and write the bench file; returns the printed
    numbers, and each request with its values (numpy) for checks."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the bench file goes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cubes = cubes_and_data()
    wc, data = cubes["regular"]
    payload = payload_to_tensor(data, dev)
    pe = PolytopeExtractor(wc.cube, device_planner=True, burst_gather=True,
                           device=dev)
    print(f"cube: {wc.cube.n_elements:,} elements "
          f"({wc.cube.nbytes / 2**20:.0f} MiB), octahedral O{wc.n}, "
          f"{wc.n_times} times × {wc.n_levels} levels\n")

    demos = regular_demos(wc)
    rows, values = [], {}
    for name, req in demos.items():
        root, stats = Slicer(wc.cube).build_index_tree(req)
        res = pe.extract(req, payload)
        plan = res.plan
        values[name] = res.values.cpu().numpy()
        largest = int(plan.run_lengths.max()) if plan.n_runs else 0
        mean = float(np.mean(values[name]))
        rows.append(dict(request=name, depth=root.depth(),
                         n_points=plan.n_points, n_slices=stats.n_slices,
                         n_slices_by_dim=dict(sorted(
                             stats.n_slices_by_dim.items())),
                         nbytes=int(plan.nbytes), n_runs=plan.n_runs,
                         largest_run=largest, mean=mean))
        print(f"{name}")
        print(f"  index tree: depth {root.depth()}, "
              f"{plan.n_points} leaf points, "
              f"{stats.n_slices} slices "
              f"{dict(sorted(stats.n_slices_by_dim.items()))}")
        print(f"  plan: {plan.nbytes:,} B in {plan.n_runs} contiguous "
              f"runs (largest {largest} elems)")
        print(f"  values: mean {mean:.2f}, "
              f"extracted in {stats.total_time_s * 1e3:.1f} ms\n")
    del payload

    iwc, idata = cubes["irregular"]
    irregular = run_irregular(iwc, idata, dev, args.out)
    return {"device": str(dev), "rows": rows, "requests": demos,
            "values": values, "irregular": irregular, "out": args.out}


if __name__ == "__main__":
    main()
