"""Repo-specific AST lint (DESIGN.md §6).

Three rules, each encoding a contract the design doc states in prose:

* ``planner-float32``   — float64 discipline in the exact host planner
  (``core/geometry.py``, ``core/hull.py``, ``core/slicer.py``): geometry
  planning must be float64 — a vertex a hair inside/outside a plane
  changes which bytes are read — so any ``float32`` literal, dtype
  attribute or cast in those files is a bug.
* ``load-then-filter``  — the data plane (``dataplane/``) must express
  selection as polytope requests, never materialize-then-mask
  (DESIGN.md §2: "There is no 'load then filter' anywhere").  Fires on
  boolean-mask subscripts — ``x[x > t]`` directly, or ``x[mask]`` where
  ``mask`` was assigned from a comparison in the same function.
* ``unchecked-i32-cast`` — in the plan/offset-carrying layers
  (``core/``, ``serve/``, ``kernels/gather/``, ``kernels/paged_attn/``,
  ``kernels/segment/``, ``kernels/slice/``, ``kernels/plan/``) and in
  ``models/``, where the port builds its kernels' ids, every int32 cast
  must go through ``repro_torch.kernels.checked_cast_i32``, which
  validates that offsets fit in int32 before any kernel truncates
  them.  A cast is numpy's ``.astype(int32)`` or ``np.int32(x)``, or
  torch's ``.to(torch.int32)`` (also ``.to(dtype=torch.int32)`` and
  ``.to(device, torch.int32)``), ``.type(torch.int32)``, a bare
  ``.int()``, or ``torch.as_tensor``/``torch.tensor``/``torch.asarray``
  of existing data with ``dtype=torch.int32``.  Creations (``zeros``,
  ``empty``, ``full``, ``arange``), reductions with ``dtype=`` and other
  keyword uses of ``torch.int32`` make new values and are not casts.

Suppression: a line carrying ``# lint-ok: <rule>`` (or a bare
``# lint-ok``) is exempt — the pragma is greppable, the prose comment it
replaces was not.

The linter is pure ``ast`` + strings; ``lint_source`` makes every rule
testable against in-memory bad-snippet fixtures.  It is the JAX
package's lint with the int32-cast rule widened to torch's forms and to
``models/``; on numpy forms the two agree.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .diagnostics import Diagnostic

# Files under src/repro_torch the float64-discipline rule covers: the exact
# host planner (geometry, hull pruning, Algorithm-1 slicer).
PLANNER_FLOAT64_FILES = (
    "core/geometry.py", "core/hull.py", "core/slicer.py")

# Path prefixes (relative to src/repro_torch) per rule.  The cast rule
# leaves out dataplane/, configs/, train/, distributed/ and launch/:
# their int32 casts are of ids drawn in range or of quantised values.
LOAD_THEN_FILTER_PATHS = ("dataplane/",)
I32_CAST_PATHS = ("core/", "serve/", "kernels/gather/",
                  "kernels/paged_attn/", "kernels/segment/",
                  "kernels/slice/", "kernels/plan/", "models/")
# The one module allowed to spell the cast: the bounds-checked helper.
I32_CAST_ALLOWLIST = ("kernels/_casting.py",)

PRAGMA = "# lint-ok"


def _pragma_lines(source: str) -> dict[int, str]:
    """1-based line → pragma suffix for lines carrying ``# lint-ok``."""
    out: dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if PRAGMA in line:
            out[i] = line.split(PRAGMA, 1)[1].lstrip(": ").strip()
    return out


def _suppressed(pragmas: dict[int, str], line: int, rule: str) -> bool:
    tag = pragmas.get(line)
    return tag is not None and (tag == "" or rule in tag)


def _is_float32(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "float32":
        return True
    if isinstance(node, ast.Name) and node.id == "float32":
        return True
    return isinstance(node, ast.Constant) and node.value == "float32"


def _is_int32_ref(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "int32":
        return True
    if isinstance(node, ast.Name) and node.id == "int32":
        return True
    return isinstance(node, ast.Constant) and node.value == "int32"


def _check_planner_float32(tree: ast.AST, rel: str,
                           pragmas: dict[int, str]) -> list[Diagnostic]:
    diags = []
    for node in ast.walk(tree):
        if not _is_float32(node):
            continue
        # Docstrings/comments mentioning float32 are fine; an exact
        # "float32" constant or attribute is a dtype reference.
        line = getattr(node, "lineno", None)
        if line is not None and _suppressed(pragmas, line, "planner-float32"):
            continue
        diags.append(Diagnostic(
            "planner-float32",
            "float32 reference in the exact host planner — geometry "
            "planning is float64 (a vertex a hair off a plane changes "
            "which bytes are read)", file=rel, line=line))
    return diags


class _MaskFilterVisitor(ast.NodeVisitor):
    """Flags boolean-mask subscripts, tracking per-function names that
    were assigned from comparisons (``mask = x > t`` … ``x[mask]``)."""

    def __init__(self, rel: str, pragmas: dict[int, str]):
        self.rel = rel
        self.pragmas = pragmas
        self.diags: list[Diagnostic] = []
        self._mask_names: list[set[str]] = [set()]

    def _visit_scope(self, node: ast.AST) -> None:
        self._mask_names.append(set())
        self.generic_visit(node)
        self._mask_names.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, (ast.Compare, ast.BoolOp)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._mask_names[-1].add(tgt.id)
        self.generic_visit(node)

    def _is_mask(self, idx: ast.AST) -> bool:
        if isinstance(idx, (ast.Compare, ast.BoolOp)):
            return True
        return (isinstance(idx, ast.Name)
                and any(idx.id in scope for scope in self._mask_names))

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, ast.Load) and self._is_mask(node.slice):
            if not _suppressed(self.pragmas, node.lineno,
                               "load-then-filter"):
                self.diags.append(Diagnostic(
                    "load-then-filter",
                    "boolean-mask selection over a materialized array — "
                    "the data plane must express selection as a polytope "
                    "request (DESIGN.md §2), not load-then-filter",
                    file=self.rel, line=node.lineno))
        self.generic_visit(node)


def _check_load_then_filter(tree: ast.AST, rel: str,
                            pragmas: dict[int, str]) -> list[Diagnostic]:
    v = _MaskFilterVisitor(rel, pragmas)
    v.visit(tree)
    return v.diags


# torch functions that convert existing data (a dtype= makes them casts).
TORCH_CONVERSIONS = ("as_tensor", "tensor", "asarray")


def _dtype_kw_is_int32(node: ast.Call) -> bool:
    return any(k.arg == "dtype" and _is_int32_ref(k.value)
               for k in node.keywords)


def _is_i32_cast(node: ast.Call) -> bool:
    f = node.func
    # direct constructor casts: np.int32(x) / jnp.int32(x)
    if _is_int32_ref(f):
        return bool(node.args)
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "astype":
        return bool(node.args) and _is_int32_ref(node.args[0])
    if f.attr == "to":
        # .to(torch.int32), .to(device, torch.int32), .to(dtype=...)
        return (any(_is_int32_ref(a) for a in node.args)
                or _dtype_kw_is_int32(node))
    if f.attr == "type":
        return ((bool(node.args) and _is_int32_ref(node.args[0]))
                or _dtype_kw_is_int32(node))
    if f.attr == "int":
        return not node.args and not node.keywords
    if (f.attr in TORCH_CONVERSIONS and isinstance(f.value, ast.Name)
            and f.value.id == "torch"):
        return (_dtype_kw_is_int32(node)
                or any(_is_int32_ref(a) for a in node.args[1:]))
    return False


def _check_i32_cast(tree: ast.AST, rel: str,
                    pragmas: dict[int, str]) -> list[Diagnostic]:
    diags = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not _is_i32_cast(node):
            continue
        if _suppressed(pragmas, node.lineno, "unchecked-i32-cast"):
            continue
        diags.append(Diagnostic(
            "unchecked-i32-cast",
            "int32 cast on an offset-carrying array outside "
            "repro_torch.kernels.checked_cast_i32 — a >2³¹-element cube "
            "silently truncates offsets here; route the cast through "
            "the bounds-checked helper", file=rel, line=node.lineno))
    return diags


def lint_source(source: str, rel: str) -> list[Diagnostic]:
    """Lint one module given its source and path relative to
    src/repro_torch."""
    rel = rel.replace("\\", "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Diagnostic("syntax", f"cannot parse: {e}", file=rel,
                           line=e.lineno)]
    pragmas = _pragma_lines(source)
    diags: list[Diagnostic] = []
    if rel in PLANNER_FLOAT64_FILES:
        diags += _check_planner_float32(tree, rel, pragmas)
    if rel.startswith(LOAD_THEN_FILTER_PATHS):
        diags += _check_load_then_filter(tree, rel, pragmas)
    if (rel.startswith(I32_CAST_PATHS)
            and rel not in I32_CAST_ALLOWLIST):
        diags += _check_i32_cast(tree, rel, pragmas)
    return diags


def lint_tree(root: str | Path) -> list[Diagnostic]:
    """Lint every module under ``root`` (the ``src/repro_torch``
    directory)."""
    root = Path(root)
    diags: list[Diagnostic] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        diags += lint_source(path.read_text(), rel)
    return diags
