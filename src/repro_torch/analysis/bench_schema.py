"""Bench-trajectory schema check.

``BENCH_*.json`` files carry the perf trajectory PR-over-PR; a file that
stops parsing or silently drops a column rots the trajectory without
failing anything.  This tiny checker pins the contract per bench family
(dispatched on the payload's ``bench`` tag): valid JSON, a ``bench``
tag, a non-empty ``rows`` list, and every row carrying the expected
keys with numeric columns — byte/point reductions for
``BENCH_extraction.json``, latency/hit-rate/coalescing for
``BENCH_serve.json``.  The port's own outputs,
``BENCH_torch_serve.json`` (``repro_torch.launch.serve``) and
``BENCH_torch_extraction.json`` (``examples/torch_extract_weather.py``),
carry the same tags and columns.  The JAX package's bench schema
check, carried unchanged.
"""

from __future__ import annotations

import json
import numbers
from pathlib import Path

from .diagnostics import Diagnostic

# key → required type (None = any JSON value)
EXTRACTION_ROW_SCHEMA: dict[str, type | None] = {
    "example": str,
    "polytope_bytes": numbers.Number,
    "bbox_bytes": numbers.Number,
    "traditional_bytes": numbers.Number,
    "n_points": numbers.Number,
    "reduction_vs_traditional": numbers.Number,
    "reduction_vs_bbox": numbers.Number,
    "plan_time_s": numbers.Number,
}

# Zipfian closed-loop load against the sharded service (launch/serve.py
# --mode extract): tail latency, cache efficacy, and cross-caller
# admission coalescing are the trajectory columns.
SERVE_ROW_SCHEMA: dict[str, type | None] = {
    "scenario": str,
    "requests": numbers.Number,
    "threads": numbers.Number,
    "shards": numbers.Number,
    "window_ms": numbers.Number,
    "p50_ms": numbers.Number,
    "p99_ms": numbers.Number,
    "req_per_s": numbers.Number,
    "hit_rate": numbers.Number,
    "coalescing_factor": numbers.Number,
}

# Device-planning / burst-gather microbench (benchmarks/roofline.py
# kernels_table): cold host-planner latency vs the fused device
# pipeline, plus gather bandwidth against the HBM roofline and the
# compressed-plan encoding ratio.
KERNELS_ROW_SCHEMA: dict[str, type | None] = {
    "scenario": str,
    "n_points": numbers.Number,
    "n_runs": numbers.Number,
    "host_plan_us": numbers.Number,
    "device_plan_us": numbers.Number,
    "plan_speedup": numbers.Number,
    "gather_us": numbers.Number,
    "burst_gather_us": numbers.Number,
    "gather_gbps": numbers.Number,
    "roofline_frac": numbers.Number,
    "compress_ratio": numbers.Number,
}

# Drifting-workload delta-planning bench (benchmarks/bench_delta.py):
# a Zipfian request stream whose polytopes translate between arrivals.
# Columns compare cold re-planning against neighborhood splicing and
# report how often the drift window actually hit.
DELTA_ROW_SCHEMA: dict[str, type | None] = {
    "scenario": str,
    "requests": numbers.Number,
    "drift_steps": numbers.Number,
    "delta_hits": numbers.Number,
    "delta_hit_rate": numbers.Number,
    "cold_plan_ms": numbers.Number,
    "warm_plan_ms": numbers.Number,
    "speedup": numbers.Number,
}

ROW_SCHEMAS: dict[str, dict[str, type | None]] = {
    "extraction": EXTRACTION_ROW_SCHEMA,
    "serve": SERVE_ROW_SCHEMA,
    "kernels": KERNELS_ROW_SCHEMA,
    "delta": DELTA_ROW_SCHEMA,
}


def check_bench_file(path: str | Path,
                     row_schema: dict | None = None) -> list[Diagnostic]:
    path = Path(path)
    rel = path.name
    if not path.exists():
        return [Diagnostic("bench-schema", "file does not exist",
                           file=rel)]
    try:
        payload = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        return [Diagnostic("bench-schema", f"invalid JSON: {e}",
                           file=rel, line=e.lineno)]
    diags: list[Diagnostic] = []
    if not isinstance(payload, dict) or "bench" not in payload:
        diags.append(Diagnostic(
            "bench-schema", "top level must be an object with a 'bench' "
            "tag", file=rel))
        return diags
    schema = row_schema
    if schema is None:
        tag = payload["bench"]
        schema = ROW_SCHEMAS.get(tag) if isinstance(tag, str) else None
        if schema is None:
            diags.append(Diagnostic(
                "bench-schema",
                f"unknown bench tag {tag!r} (registered: "
                f"{sorted(ROW_SCHEMAS)})", file=rel))
            return diags
    rows = payload.get("rows")
    if not isinstance(rows, list) or not rows:
        diags.append(Diagnostic(
            "bench-schema", "'rows' must be a non-empty list", file=rel))
        return diags
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            diags.append(Diagnostic(
                "bench-schema", f"rows[{i}] is not an object", file=rel))
            continue
        label = row.get("example") or row.get("scenario", "?")
        for key, typ in schema.items():
            if key not in row:
                diags.append(Diagnostic(
                    "bench-schema",
                    f"rows[{i}] ({label}) is missing key {key!r}",
                    file=rel))
            elif typ is not None and not isinstance(row[key], typ):
                diags.append(Diagnostic(
                    "bench-schema",
                    f"rows[{i}].{key} should be {typ.__name__}, got "
                    f"{type(row[key]).__name__}", file=rel))
    return diags
