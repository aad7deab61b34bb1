# Plan verifier (plan_check) for the port's plans: the runtime hook
# behind verify=True on Slicer / PolytopeExtractor / ExtractionService.
from .diagnostics import Diagnostic, render
from .plan_check import PlanVerificationError, check_plan, verify_plan

__all__ = ["Diagnostic", "render", "PlanVerificationError", "check_plan",
           "verify_plan"]
