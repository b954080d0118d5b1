"""Findings model for the static layout analyzer.

Own copy of ``src/repro/analysis/findings.py`` for the port.  A pass
reports :class:`Finding` objects instead of raising: every rule
violation carries a stable ``rule_id`` (``"pass/check"``), a severity, the
array it concerns, a *locus* (where in the layout/tables the violation
sits — cycle, piece index, table cell) and a machine-checkable message.
A :class:`Report` aggregates findings per analysis run, serializes to
JSON (the CI gate artifact), and converts to a structured
:class:`AnalysisError` when a caller wants errors to be fatal —
``restore_packed`` rejecting a corrupted checkpoint, ``Plan.verify()``
gating a serving launch.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Iterable, Iterator


class Severity(enum.IntEnum):
    """Ordered severity: errors are unsound layouts, warnings are
    inefficiencies or surprising-but-correct configurations."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or informational diagnostic).

    ``rule_id`` is ``"<pass>/<check>"`` (e.g. ``"interval/overlap"``);
    ``array`` names the affected array (empty for whole-layout findings);
    ``locus`` localizes the violation (``"cycle 12"``, ``"piece 3041"``,
    ``"kernel tab[4, 7]"``); ``fixit_hint`` suggests the remediation.
    """

    rule_id: str
    severity: Severity
    message: str
    array: str = ""
    locus: str = ""
    fixit_hint: str = ""

    def to_json_dict(self) -> dict[str, object]:
        return {
            "rule_id": self.rule_id,
            "severity": str(self.severity),
            "array": self.array,
            "locus": self.locus,
            "message": self.message,
            "fixit_hint": self.fixit_hint,
        }

    def render(self) -> str:
        loc = f" @ {self.locus}" if self.locus else ""
        arr = f" [{self.array}]" if self.array else ""
        hint = f"  (fix: {self.fixit_hint})" if self.fixit_hint else ""
        return f"{self.severity}: {self.rule_id}{arr}{loc}: " \
               f"{self.message}{hint}"


@dataclasses.dataclass
class Report:
    """All findings of one analysis run, plus which passes produced them."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    passes: list[str] = dataclasses.field(default_factory=list)
    subject: str = ""

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def by_severity(self, severity: Severity) -> list[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list[Finding]:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> list[Finding]:
        return self.by_severity(Severity.WARNING)

    @property
    def ok(self) -> bool:
        """True when no error-severity finding was reported."""
        return not self.errors

    def rule_ids(self) -> set[str]:
        return {f.rule_id for f in self.findings}

    def raise_if_errors(self) -> "Report":
        """Raise :class:`AnalysisError` when any error finding exists;
        chainable otherwise."""
        if not self.ok:
            raise AnalysisError(self)
        return self

    # -- serialization (the CI gate artifact) ---------------------------
    def to_json_dict(self) -> dict[str, object]:
        return {
            "subject": self.subject,
            "passes": list(self.passes),
            "ok": self.ok,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings": [f.to_json_dict() for f in self.findings],
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_json_dict(), indent=indent)

    def render(self, min_severity: Severity = Severity.INFO) -> str:
        lines = [f.render() for f in self.findings
                 if f.severity >= min_severity]
        status = "OK" if self.ok else f"FAIL ({len(self.errors)} error(s))"
        head = f"analysis[{self.subject or 'layout'}]: {status}, " \
               f"{len(self.findings)} finding(s)"
        return "\n".join([head, *lines])


class AnalysisError(ValueError):
    """A verification run found error-severity findings.

    Carries the full :class:`Report` on :attr:`report`; ``str()`` renders
    the errors so a rejected checkpoint names exactly which rule failed
    where, instead of surfacing as a shape error or silent garbage.
    """

    def __init__(self, report: Report):
        self.report = report
        errs = "; ".join(f.render() for f in report.errors) or "(none)"
        super().__init__(
            f"layout verification failed with {len(report.errors)} "
            f"error(s): {errs}"
        )
