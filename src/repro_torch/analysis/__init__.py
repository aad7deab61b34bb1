# Static verification layer of the port (DESIGN.md §6), the JAX
# package's analysis layer carried over: pure ast/json/numpy analyzers
# (importing this package imports no torch), runnable as
# `python -m repro_torch.analysis`:
#
# plan_check   — runtime/offline verifier over ExtractionPlan invariants,
#                the hook behind verify=True on Slicer /
#                PolytopeExtractor / ExtractionService
# lint         — repo-specific AST rules; its int32-cast rule also sees
#                torch's casts (.to(torch.int32), .int(), …) and models/
# concurrency  — lock-discipline race detector
# bench_schema — the BENCH_*.json contract per bench family
from .bench_schema import check_bench_file
from .concurrency import check_lock_discipline, check_lock_source
from .diagnostics import Diagnostic, render
from .lint import lint_source, lint_tree
from .plan_check import PlanVerificationError, check_plan, verify_plan

__all__ = [
    "Diagnostic", "render",
    "PlanVerificationError", "check_plan", "verify_plan",
    "lint_source", "lint_tree",
    "check_lock_discipline", "check_lock_source",
    "check_bench_file",
]
