#!/usr/bin/env python3
"""Where a kernel spends its time: its device time on variants of its
source that each change or remove one step.

    python3 chip_ablate.py [--kernel planner|b1]

``planner`` (the default) times the batched crop planner at phase 6's
crops on variants of ``csrc/batched_plan.cu``; ``b1`` times B1 on
variants of ``csrc/gather.cu`` (below).

Each variant is a copy of this checkout's ``src`` under
``build/ablation/<kernel>/<name>/`` with textual edits to the kernel's source
(``VARIANTS``; an edit that does not match exactly once stops the
script), timed in a process of its own, so that each imports its own
``repro_torch`` and builds its own kernels:

* ``warps_4``, ``warps_16``: at most 4 or 16 warps a block (8 in the
  kernel; phase 6's chunks of 32 rows × 56 columns take at most 14);
* ``unstaged``: the axes read in device memory, never staged in shared
  memory;
* ``no_cut``: every live row cut at a fixed [y, y + 10] of its first
  vertex, without B4's device function;
* ``no_col_search``: a row's first column from its cut's lower extent
  over the axis' first step, without the binary search;
* ``no_row_search``: the first row the same way on axis 0, without the
  warp-wide search;
* ``no_cut_no_col_search``: both.

The ablations compute other plans (``equal`` says whether the variant's
lattice, counts and values equal the plain version's); they show what
each step costs, not a kernel to keep.  The inputs are
``chip_smoke.batched_crops``' 256 crops of the five countries on a
one-level F320 cube (the grid and the crops of phase 6; the field's
values are another draw, which the timing does not see).  Each variant
prints one JSON line with the device time (``chip_smoke.kernel_breakdown``)
of the extract and of the lattice alone, three readings each; ``base``
runs first and last.

B1's variants (``B1_VARIANTS``) tune its constants (``ROWS_*`` in
``csrc/gather.cu``):

* ``threads_128``, ``threads_512``: 128 or 512 threads a block (256);
* ``cap_8``: the grid capped at 8 blocks an SM (32), so that warps
  stride over more tiles.

Each times B1 (``kernel.gather_rows`` with ``ROWS_PER_GROUP`` of the
case's group set to 1, 2, 4 and 8 in turn) by
device time, each call byte-equal to the plain version, at the plain
extract's read (Germany over all levels on phase 2's F320 cube: M =
174,640 offsets into the 1.94 GB float64 payload), at two-tower's
``retrieval_cand`` lookup (``chip_smoke.b1_candidate_case``) and at phase
12's row-width sweep (``chip_smoke.b1_sweep_cases``); ``base`` also
times ``index_select`` on the same inputs.  The tables hold random
values drawn on the card: the timing does not see them.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke

HERE = Path(__file__).resolve().parent
KERNEL = Path("repro_torch/csrc/batched_plan.cu")
SEED = 0

_CUT = ("const MinorExtents<T> cut = slice_minor_extents<T>(\n"
        "                    pv, pv + 1, 2, pm, v, row_val, tol);")
_FIXED_CUT = "const MinorExtents<T> cut{pv[1], pv[1] + (T)10, true};"
_COL_SEARCH = "c_start = lower_bound(a1, len1, cut.lo - eps);"
_COL_STEP = "c_start = (long long)((cut.lo - a1[0]) / (a1[1] - a1[0]));"
_ROW_SEARCH = "const int64_t start = warp_lower_bound(a0, len0, lo0 - eps);"
_ROW_STEP = ("const int64_t start = "
             "(int64_t)((lo0 - a0[0]) / (a0[1] - a0[0]));")
B1_KERNEL = Path("repro_torch/csrc/gather.cu")
B1_VARIANTS = {
    "base": [],
    "threads_128": [("constexpr int ROWS_THREADS = 256;",
                     "constexpr int ROWS_THREADS = 128;")],
    "threads_512": [("constexpr int ROWS_THREADS = 256;",
                     "constexpr int ROWS_THREADS = 512;")],
    "cap_8": [("constexpr int ROWS_BLOCKS_PER_SM = 32;",
               "constexpr int ROWS_BLOCKS_PER_SM = 8;")],
}
VARIANTS = {
    "base": [],
    "warps_4": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "warps_16": [("constexpr int WARPS = 8;", "constexpr int WARPS = 16;")],
    "unstaged": [("const bool stage = COUNT_BYTES + axes_bytes <= "
                  "SHARED_BYTES;", "const bool stage = false;")],
    "no_cut": [(_CUT, _FIXED_CUT)],
    "no_col_search": [(_COL_SEARCH, _COL_STEP)],
    "no_row_search": [(_ROW_SEARCH, _ROW_STEP)],
    "no_cut_no_col_search": [(_CUT, _FIXED_CUT), (_COL_SEARCH, _COL_STEP)],
}


def make_tree(kernel: str, name: str) -> Path:
    """A copy of this checkout's ``src`` with the variant's edits."""
    path, variants = TARGETS[kernel]
    src = HERE / "build" / "ablation" / kernel / name / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(HERE / "src" / "repro_torch",
                    src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    text = (src / path).read_text()
    for old, new in variants[name]:
        assert text.count(old) == 1, f"{name}: {old!r} not found once"
        text = text.replace(old, new)
    (src / path).write_text(text)
    return src


def time_tree(name: str, src: Path) -> dict:
    """The device time of one tree's planner at phase 6's crops."""
    sys.path.insert(0, str(src.resolve()))
    import torch

    from repro_torch.dataplane.weather import COUNTRIES, IrregularWeatherCube
    from repro_torch.kernels.slice import kernel as sk
    from repro_torch.kernels.slice import ops as sops
    from repro_torch.kernels.slice import ref as sref

    assert Path(sk.__file__).resolve().is_relative_to(src.resolve())
    dev = torch.device("cuda")
    iwc = IrregularWeatherCube(n_dates=1, times_per_day=1, n_levels=1,
                               n_lat=640, n_lon=1280)
    requests = {c: iwc.country_request(c) for c in COUNTRIES}
    bc = chip_smoke.batched_crops(iwc, requests, iwc.field_data(seed=SEED),
                                  SEED)
    verts, valid = sops.pack_polytopes(bc["crops"], device=dev)
    a0, a1 = (torch.from_numpy(bc[k]).to(dev) for k in ("axis0", "axis1"))
    field = torch.from_numpy(bc["field"]).to(dev)
    args = (verts, valid, a0, a1, bc["n0"], bc["n1"], bc["max_rows"],
            bc["max_cols"])
    got = sk.batched_plan_2d(*args, field)
    want = sref.batched_plan_2d(*args, field)
    row = {"variant": name, "equal": all(
        chip_smoke.bytes_equal(g, w) for g, w in zip(got, want))}
    for what, f in (("extract", field), ("lattice", None)):
        row[what + "_device_ms"] = [chip_smoke.kernel_breakdown(
            lambda: sk.batched_plan_2d(*args, f))["device_ms"]
            for _ in range(3)]
    return row


def b1_cases(dev):
    """B1's inputs: (label, table, ids) at the plain extract's read, at
    two-tower's ``retrieval_cand`` lookup and at each width of phase
    12's sweep, one at a time."""
    import torch

    from repro_torch.core import Slicer

    gen = torch.Generator(device=dev).manual_seed(SEED)
    iwc, requests = chip_smoke.weather_setup()
    plan = Slicer(iwc.cube).extract_plan(requests["germany_all_levels"])[0]
    flat = torch.randn(iwc.cube.n_elements, generator=gen, device=dev,
                       dtype=torch.float64)
    yield ("plain extract, D = 1 float64", flat[:, None],
           torch.from_numpy(plan.offsets.astype("int32")).to(dev))
    del flat
    yield ("two-tower retrieval_cand, 1 KB rows",
           *chip_smoke.b1_candidate_case(dev, SEED))
    torch.cuda.empty_cache()
    yield from chip_smoke.b1_sweep_cases(dev, SEED)


def time_b1(name: str, src: Path) -> dict:
    """One tree's B1 at each case of ``b1_cases``, at 1, 2, 4 and 8 rows
    a group."""
    sys.path.insert(0, str(src.resolve()))
    import torch

    from repro_torch.kernels.gather import kernel as gk
    from repro_torch.kernels.gather import ref as gref

    assert Path(gk.__file__).resolve().is_relative_to(src.resolve())
    dev = torch.device("cuda")
    gk.MIN_WARPS = 0                    # R as set, at every M
    rows = []
    for label, table, idx in b1_cases(dev):
        vec, group, _ = gk.rows_layout(table.shape[1], table.element_size(),
                                       idx.numel(), table.data_ptr(), 0)
        want = gref.gather_rows(table, idx)
        row = {"case": label, "vec_bytes": vec, "group": group,
               "bound_ms": chip_smoke.b1_bound(table, idx)["bound_ms"],
               "device_ms": {}}
        for r in (1, 2, 4, 8):
            gk.ROWS_PER_GROUP[group] = r
            assert chip_smoke.bytes_equal(gk.gather_rows(table, idx),
                                          want), (label, r)
            row["device_ms"][r] = chip_smoke.kernel_breakdown(
                lambda: gk.gather_rows(table, idx))["device_ms"]
        if name == "base":
            row["index_select_device_ms"] = chip_smoke.kernel_breakdown(
                lambda: torch.index_select(table, 0, idx))["device_ms"]
        del want
        rows.append(row)
    return {"variant": name, "cases": rows}


TARGETS = {"planner": (KERNEL, VARIANTS), "b1": (B1_KERNEL, B1_VARIANTS)}
TIMERS = {"planner": time_tree, "b1": time_b1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(TARGETS), default="planner")
    ap.add_argument("--time", nargs=2, metavar=("NAME", "SRC"),
                    help=argparse.SUPPRESS)   # one variant, in its process
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device is available", file=sys.stderr)
        return 1
    timer = TIMERS[args.kernel]
    if args.time:
        chip_smoke.emit(timer(args.time[0], Path(args.time[1])))
        return 0
    print(chip_smoke.card_line(), flush=True)
    rc = 0
    for name in [*TARGETS[args.kernel][1], "base"]:
        src = make_tree(args.kernel, name)
        rc |= subprocess.run([sys.executable, __file__, "--kernel",
                              args.kernel, "--time", name, str(src)],
                             cwd=HERE).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
