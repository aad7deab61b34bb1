"""Lock-discipline race detector (DESIGN.md §6).

A static checker for the threaded serving layer
(``serve/extraction.py``, ``dataplane/pipeline.py`` — and anything else
that grows locks as the async-admission work lands).  Per class it

1. finds the lock attributes — ``self.X`` used as a ``with`` context
   manager where ``X`` ends in ``lock``;
2. infers the *protected set*: the first attribute after ``self`` in
   every assignment target written inside a ``with self._lock:`` body
   (``self.cache.stats.hits += 1`` protects ``cache``; subscript stores
   count too — ``self._od[key] = plan`` protects ``_od``);
3. flags any access — read or write — to a protected attribute outside
   a lock body.

``__init__`` is exempt (construction happens-before publication), and a
line carrying ``# unlocked-ok: <reason>`` is exempt — the pragma turns
"gather outside the lock is fine because plans are immutable" from a
prose comment into an annotation the checker verifies is present.

The JAX package's lock checker, carried unchanged: it reads source, so
it checks either package.

Protection is inferred from *writes only*: method calls under the lock
(``self.extractor.plan(...)``) do not mark ``extractor`` protected,
otherwise every collaborator touched inside the critical section would
poison the whole class with false positives.  The checker is therefore
deliberately one-sided: it can miss a mutation hidden behind a method
call, but everything it flags is a genuine unguarded access to state the
class itself mutates under its lock.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .diagnostics import Diagnostic

PRAGMA = "# unlocked-ok"


def _pragma_lines(source: str) -> set[int]:
    return {i for i, line in enumerate(source.splitlines(), start=1)
            if PRAGMA in line}


def _self_root(node: ast.AST) -> str | None:
    """For an attribute chain rooted at ``self``, the first attribute
    after ``self`` (``self.cache.stats.hits`` → ``cache``)."""
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        node = node.value
    return None


def _is_lock_ctx(expr: ast.AST) -> str | None:
    """``with self.X:`` where X looks like a lock → X."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and expr.attr.lower().endswith("lock"):
        return expr.attr
    # also accept self._lock.acquire()-style contexts via with self._lock:
    return None


class _ProtectedCollector(ast.NodeVisitor):
    """Pass 1: attributes written under a ``with self.<lock>`` body."""

    def __init__(self) -> None:
        self.locks: set[str] = set()
        self.protected: set[str] = set()
        self._depth = 0

    def visit_With(self, node: ast.With) -> None:
        is_lock = False
        for item in node.items:
            lock = _is_lock_ctx(item.context_expr)
            if lock is not None:
                self.locks.add(lock)
                is_lock = True
        if is_lock:
            self._depth += 1
            for stmt in node.body:
                self.visit(stmt)
            self._depth -= 1
        else:
            self.generic_visit(node)

    def _record_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._record_target(elt)
            return
        while isinstance(tgt, (ast.Subscript, ast.Starred)):
            tgt = tgt.value
        root = _self_root(tgt)
        if root is not None:
            self.protected.add(root)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._depth:
            for tgt in node.targets:
                self._record_target(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self._depth:
            self._record_target(node.target)
        self.generic_visit(node)


class _UnguardedFinder(ast.NodeVisitor):
    """Pass 2: accesses to protected attributes outside lock bodies."""

    def __init__(self, cls: str, rel: str, protected: set[str],
                 pragmas: set[int]):
        self.cls = cls
        self.rel = rel
        self.protected = protected
        self.pragmas = pragmas
        self.diags: list[Diagnostic] = []
        self._locked = 0
        self._seen: set[tuple[int, str]] = set()

    def visit_With(self, node: ast.With) -> None:
        if any(_is_lock_ctx(i.context_expr) for i in node.items):
            self._locked += 1
            for stmt in node.body:
                self.visit(stmt)
            self._locked -= 1
        else:
            self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        root = _self_root(node)
        if (root in self.protected and not self._locked
                and node.lineno not in self.pragmas
                and (node.lineno, root) not in self._seen):
            self._seen.add((node.lineno, root))
            self.diags.append(Diagnostic(
                "lock-discipline",
                f"{self.cls}.{root} is written under the lock but "
                f"accessed here without it — take the lock or annotate "
                f"the line with '# unlocked-ok: <reason>'",
                file=self.rel, line=node.lineno))
        self.generic_visit(node)


def check_lock_source(source: str, rel: str) -> list[Diagnostic]:
    """Check one module's lock discipline from source text."""
    rel = rel.replace("\\", "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Diagnostic("syntax", f"cannot parse: {e}", file=rel,
                           line=e.lineno)]
    pragmas = _pragma_lines(source)
    diags: list[Diagnostic] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        collector = _ProtectedCollector()
        for stmt in node.body:
            collector.visit(stmt)
        protected = collector.protected - collector.locks
        if not protected:
            continue
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name != "__init__":
                finder = _UnguardedFinder(node.name, rel, protected,
                                          pragmas)
                finder.visit(stmt)
                diags += finder.diags
    return diags


def check_lock_discipline(root: str | Path) -> list[Diagnostic]:
    """Check every module under ``root`` (the ``src/repro_torch``
    directory)."""
    root = Path(root)
    diags: list[Diagnostic] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        diags += check_lock_source(path.read_text(), rel)
    return diags
