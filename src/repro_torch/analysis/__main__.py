"""CLI for the port's static verification layer (DESIGN.md §6).

    python -m repro_torch.analysis --all            # the CI gate (the card)
    python -m repro_torch.analysis --all --device cpu
    python -m repro_torch.analysis --lint --locks   # source analyzers only
    python -m repro_torch.analysis --plan p.pkl     # verify a pickled plan
    python -m repro_torch.analysis --bench BENCH_torch_extraction.json

Exits non-zero on any diagnostic.  ``--all`` runs the lint, the
lock-discipline checker, the bench schema check (on the port's own
``BENCH_torch_serve.json`` and ``BENCH_torch_extraction.json`` in the
working directory, where they exist) and a planner self-check: the JAX
package's self-check plans built by the port's device planner on
``--device`` (the card by default, where B3 plans the eligible
requests), each required to verify clean.

The source analyzers and ``--bench``/``--plan`` are pure ast/json and
touch no device; only ``--self-check`` imports the planner.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .bench_schema import check_bench_file
from .concurrency import check_lock_discipline
from .diagnostics import Diagnostic, render
from .lint import lint_tree
from .plan_check import check_plan, check_plan_file

# The port's bench outputs that --all checks when they exist.
DEFAULT_BENCH_FILES = ("BENCH_torch_serve.json",
                       "BENCH_torch_extraction.json")


def _default_src_root() -> Path:
    # in-repo layout: .../src/repro_torch/analysis/__main__.py → src/repro_torch
    return Path(__file__).resolve().parents[1]


def self_check(device=None) -> list[Diagnostic]:
    """Verify the device planner's plans on small cubes (imports
    repro_torch.core); ``device=None`` means the card."""
    import numpy as np

    from repro_torch.core import (Box, OrderedAxis, Polygon,
                                  PolytopeExtractor, Request, Select,
                                  TensorDatacube)

    cube = TensorDatacube([
        OrderedAxis("t", np.arange(4.0)),
        OrderedAxis("x", np.arange(32.0)),
        OrderedAxis("y", np.arange(32.0)),
    ])
    tri = np.array([[4.0, 2.0], [28.0, 9.0], [15.0, 30.0]])
    requests = {
        "box": Request([Select("t", [1.0]),
                        Box(("x", "y"), [3.0, 4.0], [10.0, 21.0])]),
        "triangle": Request([Select("t", [0.0]), Polygon(("x", "y"), tri)]),
        "span_all": Request([Box(("t", "x"), [0.0, 0.0], [3.0, 31.0])]),
    }
    pe = PolytopeExtractor(cube, device_planner=True, device=device)
    diags: list[Diagnostic] = []
    for name, req in requests.items():
        plan, stats = pe.plan(req)
        for d in check_plan(plan, datacube=cube, stats=stats):
            diags.append(Diagnostic(d.rule, f"[self-check {name}] "
                                    + d.message))
    return diags


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verification layer of the port: plan "
                    "checker, AST lint, lock-discipline race detector, "
                    "bench schema check.")
    ap.add_argument("--all", action="store_true",
                    help="run lint + locks + bench + planner self-check "
                         "(the CI gate)")
    ap.add_argument("--lint", action="store_true", help="AST lint rules")
    ap.add_argument("--locks", action="store_true",
                    help="lock-discipline checker")
    ap.add_argument("--self-check", action="store_true",
                    help="verify the device planner's plans on small "
                         "cubes")
    ap.add_argument("--bench", nargs="*", metavar="JSON",
                    help="bench files to schema-check (default: "
                         + " / ".join(DEFAULT_BENCH_FILES)
                         + " when present)")
    ap.add_argument("--plan", nargs="*", metavar="PKL", default=[],
                    help="pickled ExtractionPlan files to verify")
    ap.add_argument("--n-elements", type=int, default=None,
                    help="datacube element count for --plan bounds checks")
    ap.add_argument("--root", type=Path, default=None,
                    help="source root to analyze (default: the installed "
                         "repro_torch package directory)")
    ap.add_argument("--device", default="cuda",
                    help="where the self-check plans (cuda: B3 on the "
                         "card; cpu: the plain versions)")
    args = ap.parse_args(argv)

    src_root = args.root if args.root is not None else _default_src_root()
    diags: list[Diagnostic] = []
    ran = False

    if args.all or args.lint:
        ran = True
        diags += lint_tree(src_root)
    if args.all or args.locks:
        ran = True
        diags += check_lock_discipline(src_root)
    bench_files = list(args.bench or [])
    if args.all and not bench_files:
        for name in DEFAULT_BENCH_FILES:
            default_bench = Path.cwd() / name
            if default_bench.exists():
                bench_files.append(default_bench)
    for bf in bench_files:
        ran = True
        diags += check_bench_file(bf)
    for pf in args.plan:
        ran = True
        diags += check_plan_file(pf, n_elements=args.n_elements)
    if args.all or args.self_check:
        ran = True
        diags += self_check(args.device)

    if not ran:
        ap.print_help()
        return 2
    if diags:
        print(render(diags), file=sys.stderr)
        print(f"\n{len(diags)} diagnostic(s).", file=sys.stderr)
        return 1
    print("repro_torch.analysis: all checks clean.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
