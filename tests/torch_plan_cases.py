"""Synthetic inputs of B3 (``plan_runs_2d``) for the port's tests: the
cases that stress the one-launch kernel's order, shared by the card's
tests (``test_torch_cuda.py``) and the CPU emulation of that order
(``test_torch_scan_tiles.py``).  Needs numpy only.  Not a test module."""

from __future__ import annotations

import numpy as np


def plan_scan_case(jobs: int, max_rows: int, kind: str, seed: int,
                   dtype=np.float64):
    """Synthetic B3 inputs in ``plan_runs_2d`` argument order (numpy) and
    the keyword arguments.  Triangles and quads on a latitude axis of 96
    rows 1° apart and a longitude axis of 144 columns 2.5° apart; each job
    spans up to ``max_rows`` rows.  ``kind``: "seam" is cyclic (period
    360°) with every fourth job (from job 1) across the seam, so its rows
    hold two segments; "plain" is not cyclic; "none" puts every job above
    the axis, so the call has n_runs = 0.  In every kind, every fifth job
    (from job 2) lies between two columns (rows but no runs), every
    seventh (from job 3) above the axis (no rows), and every third has a
    vertex on a row."""
    rng = np.random.default_rng(seed)
    n0, n1, v = 96, 144, 4
    sv0 = np.arange(n0, dtype=np.float64) - 48.0
    sv1 = np.arange(n1, dtype=np.float64) * 2.5
    lat = rng.uniform(-40.0, 40.0, jobs)
    half = rng.uniform(0.3, (max_rows - 1) / 2, jobs)
    lon = rng.uniform(5.0, 300.0, jobs)
    half_lon = rng.uniform(1.0, 30.0, jobs)
    if kind == "seam":
        lon[1::4] = rng.uniform(345.0, 375.0, len(lon[1::4]))
    lon[2::5] = 2.5 * rng.integers(2, 100, len(lon[2::5])) + 1.25
    half_lon[2::5] = 0.5
    lat[3::7] = 200.0
    if kind == "none":
        lat[:] = 200.0
    u = rng.uniform(-1.0, 1.0, (jobs, v))
    u[:, :2] = (-1.0, 1.0)                     # the span's two ends
    verts = np.stack([lat[:, None] + half[:, None] * u,
                      lon[:, None] + half_lon[:, None]
                      * rng.uniform(-1.0, 1.0, (jobs, v))], axis=-1)
    verts[::3, 2, 0] = np.round(verts[::3, 2, 0])          # on a row
    valid = np.arange(v)[None, :] < rng.integers(3, v + 1, jobs)[:, None]
    verts[~valid] = 0.0
    base = (rng.integers(0, 8, jobs) * n0 * n1).astype(np.int32)
    rowoff = (np.arange(n0) * n1).astype(np.int32)
    cyclic = kind != "plain"
    scalars = np.array([1e-9 * 48.0, 1e-9 * 357.5, 1e-9,
                        360.0 if cyclic else 0.0])
    args = (verts.astype(dtype), valid, base, sv0.astype(dtype), rowoff,
            sv1.astype(dtype), scalars.astype(dtype))
    return args, dict(n0=n0, n1=n1, max_rows=max_rows, cyclic=cyclic)


# (jobs, max_rows, kind): jobs not a multiple of the 4-job tile, a warp's
# 32 rows and more (the row loop), the seam, no hits, n_runs = 0.
PLAN_SCAN_CASES = [(1, 8, "seam"), (31, 24, "seam"), (32, 40, "seam"),
                   (33, 24, "plain"), (33, 72, "seam"), (7, 40, "none")]
