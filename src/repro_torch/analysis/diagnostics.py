"""Shared diagnostic record for every analyzer in ``repro_torch.analysis``.

One flat record type keeps the CLI, the CI gate, and the fixture tests
uniform: an analyzer returns ``list[Diagnostic]`` and an empty list means
the checked artifact honours its contract.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Diagnostic:
    """One violation found by a static analyzer.

    ``rule`` is a stable kebab-case identifier (tests key on it), ``file``
    and ``line`` locate source-level findings (both None for plan-level
    findings, which have no source location).
    """

    rule: str
    message: str
    file: str | None = None
    line: int | None = None
    severity: str = "error"

    def __str__(self) -> str:
        loc = ""
        if self.file is not None:
            loc = f"{self.file}:{self.line if self.line else '?'}: "
        return f"{loc}[{self.rule}] {self.message}"


def render(diagnostics: list[Diagnostic]) -> str:
    return "\n".join(str(d) for d in diagnostics)
