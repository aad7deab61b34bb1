"""Plan verifier: machine-checks ``ExtractionPlan`` invariants.

The paper's contract is byte-exactness — Algorithm 1 pre-selects "the
precise bytes of data which the user needs".  A single out-of-bounds
offset, a run that no longer tiles the offset set, or an offset past
2³¹ (silently truncated the moment ``kernels/gather`` casts indices to
int32) breaks that contract invisibly: small-cube tests keep passing
while a production-scale cube reads the wrong bytes.  ``check_plan``
states the invariants as code:

* offsets are a 1-D integer array, in-bounds for the datacube;
* offsets are strictly ascending (sorted + deduped — ``flatten`` sorts
  by storage offset so runs are ascending burst reads);
* ``(run_start, run_length)`` coalesced runs exactly tile the offset
  set: expanding the runs reproduces ``offsets`` element-for-element;
* every offset fits in int32 **before** any kernel consumes it
  (``kernels/gather`` scalar-prefetch indices are int32);
* every coordinate column has one entry per extracted point;
* when ``SliceStats`` are supplied and the cube's axis sizes are
  derivable, the paper's §5.2 bound  N_slices ≤ Σ_i Π_{j≤i} n_j  holds.

Everything here is duck-typed over the plan/datacube attributes and
imports nothing from the rest of the package — the checker stays free
of circular imports, so ``Slicer``/``ExtractionService``
can call it lazily under ``verify=True``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .diagnostics import Diagnostic, render

I32_LIMIT = 2 ** 31


class PlanVerificationError(ValueError):
    """Raised by :func:`verify_plan` when a plan violates its contract."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = diagnostics
        super().__init__(
            f"{len(diagnostics)} plan invariant violation(s):\n"
            + render(diagnostics))


def _axis_sizes(datacube: Any) -> list[int] | None:
    """Axis lengths in natural order, or None when not derivable from a
    path-free lookup (e.g. the octahedral cube's row-dependent lon)."""
    names = getattr(datacube, "axis_names", None)
    if names is None:
        return None
    try:
        return [len(datacube.axis(n, {})) for n in names]
    except Exception:
        return None


def check_plan(plan: Any, *, datacube: Any = None,
               n_elements: int | None = None,
               stats: Any = None) -> list[Diagnostic]:
    """Pure function: plan (+ optional datacube/stats) → diagnostics."""
    diags: list[Diagnostic] = []
    offs = np.asarray(plan.offsets)
    starts = np.asarray(plan.run_starts)
    lengths = np.asarray(plan.run_lengths)

    if offs.ndim != 1 or offs.dtype.kind not in "iu":
        diags.append(Diagnostic(
            "plan-offsets-dtype",
            f"offsets must be a 1-D integer array, got shape {offs.shape} "
            f"dtype {offs.dtype}"))
        return diags  # nothing downstream is meaningful

    if n_elements is None and datacube is not None:
        n_elements = getattr(datacube, "n_elements", None)

    if len(offs):
        lo, hi = int(offs.min()), int(offs.max())
        if lo < 0:
            diags.append(Diagnostic(
                "plan-bounds", f"negative offset {lo}"))
        if n_elements is not None and hi >= n_elements:
            diags.append(Diagnostic(
                "plan-bounds",
                f"offset {hi} out of bounds for a datacube of "
                f"{n_elements} elements"))
        if hi >= I32_LIMIT:
            itemsize = int(getattr(plan, "itemsize", 8))
            size = (f"{n_elements} elements "
                    f"(~{n_elements * itemsize / 2**30:.1f} GiB)"
                    if n_elements is not None else "unknown size")
            diags.append(Diagnostic(
                "plan-i32",
                f"offset {hi} does not fit in int32 (limit {I32_LIMIT - 1}); "
                f"datacube has {size} — kernels/gather casts offsets to "
                f"int32, so this plan would silently read the wrong bytes"))
        d = np.diff(offs)
        if np.any(d < 0):
            diags.append(Diagnostic(
                "plan-sorted",
                "offsets are not sorted ascending (flatten emits plans in "
                "storage order so runs are ascending burst reads)"))
        elif np.any(d == 0):
            diags.append(Diagnostic(
                "plan-dedup", "offsets contain duplicates"))

    # -- runs must exactly tile the offset set -----------------------------
    if len(starts) != len(lengths):
        diags.append(Diagnostic(
            "plan-runs-tile",
            f"{len(starts)} run starts vs {len(lengths)} run lengths"))
    elif len(lengths) and int(lengths.min()) < 1:
        diags.append(Diagnostic(
            "plan-run-length",
            f"non-positive run length {int(lengths.min())}"))
    else:
        total = int(lengths.sum()) if len(lengths) else 0
        if total != len(offs):
            diags.append(Diagnostic(
                "plan-runs-tile",
                f"runs cover {total} elements but the plan has "
                f"{len(offs)} offsets"))
        else:
            rebuilt = np.repeat(starts, lengths) + _run_ramp(lengths)
            if not np.array_equal(rebuilt, offs):
                diags.append(Diagnostic(
                    "plan-runs-tile",
                    "expanding (run_start, run_length) runs does not "
                    "reproduce the offset set"))

    # -- coordinate columns ------------------------------------------------
    coords = getattr(plan, "coords", None) or {}
    for name, col in coords.items():
        if len(col) != len(offs):
            diags.append(Diagnostic(
                "plan-coords",
                f"coords[{name!r}] has {len(col)} entries for "
                f"{len(offs)} points"))

    # -- paper §5.2 slice-count bound --------------------------------------
    if stats is not None and datacube is not None:
        sizes = _axis_sizes(datacube)
        if sizes:
            bound, prod = 0, 1
            for n in sizes:
                prod *= n
                bound += prod
            if stats.n_slices > bound:
                diags.append(Diagnostic(
                    "plan-slice-bound",
                    f"{stats.n_slices} slices exceeds the §5.2 bound "
                    f"Σ_i Π_j≤i n_j = {bound} for axis sizes {sizes}"))
    return diags


def _run_ramp(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] — per-run arange for run expansion."""
    if not len(lengths):
        return np.empty(0, np.int64)
    ends = np.cumsum(lengths)
    ramp = np.arange(int(ends[-1]), dtype=np.int64)
    return ramp - np.repeat(ends - lengths, lengths)


def verify_plan(plan: Any, *, datacube: Any = None,
                n_elements: int | None = None, stats: Any = None) -> None:
    """Raise :class:`PlanVerificationError` unless the plan is clean."""
    diags = check_plan(plan, datacube=datacube, n_elements=n_elements,
                       stats=stats)
    if diags:
        raise PlanVerificationError(diags)


def check_plan_file(path: str,
                    n_elements: int | None = None) -> list[Diagnostic]:
    """CLI entry: verify a pickled plan.

    Accepts either a bare ``ExtractionPlan`` pickle or a dict with keys
    ``plan`` and (optionally) ``n_elements``.
    """
    import pickle

    try:
        with open(path, "rb") as fh:
            obj = pickle.load(fh)
    except Exception as e:
        return [Diagnostic("plan-file", f"cannot load plan: {e}",
                           file=path)]
    if isinstance(obj, dict):
        plan = obj.get("plan", obj)
        n_elements = obj.get("n_elements", n_elements)
    else:
        plan = obj
    diags = check_plan(plan, n_elements=n_elements)
    return [Diagnostic(d.rule, d.message, file=path, line=d.line)
            for d in diags]
