"""Quickstart on the PyTorch port: the Polytope algorithm in five minutes.

Builds the paper's datacube (an octahedral weather grid), extracts a
country polygon, a time-series, and a flight path, and prints the
byte-reduction table vs the bounding-box / whole-field baselines —
a miniature of the paper's Table 1, as ``examples/quickstart.py`` does.
The payload goes to the device once; the extractor plans on the device
where a request is eligible (the planning kernel on the card) and reads
each plan's runs with the burst gather.

  PYTHONPATH=src python examples/torch_quickstart.py              # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.carry import payload_to_tensor
from repro_torch.core import (BoundingBoxExtractor, PolytopeExtractor,
                              TraditionalExtractor)
from repro_torch.dataplane.weather import WeatherCube, paris_newyork_path

# O128 grid: 66 560 points/field (the paper uses O1280 = 6.6M; same
# geometry, friendlier for a quickstart)
GRID = dict(n=128, n_times=8, n_levels=10)
SEED = 0


def cube_and_data() -> tuple[WeatherCube, np.ndarray]:
    """The example's cube and its flat payload on the host."""
    wc = WeatherCube(**GRID)
    return wc, wc.field_data(seed=SEED)


def requests_of(wc: WeatherCube) -> dict:
    return {
        "country: France": wc.country_request("france"),
        "country: Norway": wc.country_request("norway"),
        "timeseries London 8 steps": wc.timeseries_request(
            51.5, 0.0, 0.0, 7 * 3600.0),
        "flight path Paris→NY": wc.flight_path_request(
            paris_newyork_path(wc), width=1.5),
    }


def main(argv: list[str] | None = None) -> dict:
    """Print the table; returns its rows, the France summary, and each
    request with its values (numpy) for checks."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    wc, data = cube_and_data()
    payload = payload_to_tensor(data, dev)
    pe = PolytopeExtractor(wc.cube, device_planner=True, burst_gather=True,
                           device=dev)
    bb = BoundingBoxExtractor(wc.cube)
    tr = TraditionalExtractor(wc.cube)
    requests = requests_of(wc)

    print(f"{'request':<28}{'polytope':>10}{'bbox':>12}"
          f"{'whole-field':>14}{'vs bbox':>9}{'vs trad':>10}")
    print("-" * 83)
    rows, values = [], {}
    for name, req in requests.items():
        res = pe.extract(req, payload)
        values[name] = res.values.cpu().numpy()
        box = bb.plan(req)
        trad = tr.nbytes(req)
        red_b = box.nbytes / max(res.plan.nbytes, 1)
        red_t = trad / max(res.plan.nbytes, 1)
        rows.append(dict(request=name, polytope_bytes=int(res.plan.nbytes),
                         bbox_bytes=int(box.nbytes),
                         traditional_bytes=int(trad),
                         n_points=res.plan.n_points, n_runs=res.plan.n_runs,
                         reduction_vs_bbox=red_b,
                         reduction_vs_traditional=red_t))
        print(f"{name:<28}{res.plan.nbytes:>9,}B{box.nbytes:>11,}B"
              f"{trad:>13,}B{red_b:>8.1f}x{red_t:>9,.0f}x")

    res = pe.extract(requests["country: France"], payload)
    mean = float(np.mean(res.values.cpu().numpy()))
    print(f"\nFrance: {res.plan.n_points} points in "
          f"{res.plan.n_runs} contiguous runs; mean temp "
          f"{mean:.2f} "
          f"(slicing {res.stats.slicing_time_s * 1e3:.1f} ms)")
    return {"device": str(dev), "rows": rows,
            "france": dict(n_points=res.plan.n_points,
                           n_runs=res.plan.n_runs, mean=mean),
            "requests": requests, "values": values}


if __name__ == "__main__":
    main()
