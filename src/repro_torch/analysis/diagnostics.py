"""The structured-diagnostic model of the artifact verifier; port of
``repro/analysis/diagnostics.py``.

Every invariant the verifier proves (or refutes) about a compiled
:class:`~repro_torch.core.program.Program` is reported as a
:class:`Diagnostic`: a stable code (``SCHED003``), a severity, a
structured :class:`Location` naming the offending (post, SPU, slot,
header field), a message and a fix hint. Checker modules register
their codes at import time with :func:`register_code`, and
:func:`repro_torch.analysis.verify.verify` refuses diagnostics with
unregistered codes. :data:`CODES` is the port's own registry; it holds
the reference's codes and titles once the checkers are imported.

A :class:`VerifyReport` is the output of one verification run:
diagnostics, per-checker facts, and wall time. ``report.ok`` means "no
ERROR diagnostic", the gate of
``ProgramRegistry.register(verify=True)``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any


class Severity(enum.IntEnum):
    """Diagnostic severity; ordering is by increasing gravity."""
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Location:
    """Where in the artifact a diagnostic points.

    All fields are optional; ``spu``/``slot`` address the OpTables
    grid, ``post``/``pre`` are global neuron indices, and ``field``
    names a persisted header entry (for the stale-header audit).
    """
    spu: int | None = None
    slot: int | None = None
    post: int | None = None
    pre: int | None = None
    field: str | None = None

    def __str__(self) -> str:
        parts = [f"{k}={v}" for k, v in (
            ("spu", self.spu), ("slot", self.slot), ("post", self.post),
            ("pre", self.pre), ("field", self.field)) if v is not None]
        return ", ".join(parts) if parts else "-"

    def to_json(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verified-invariant violation (or notice) in an artifact."""
    code: str                        # stable registry key, e.g. "SCHED003"
    severity: Severity
    message: str                     # human text; legacy-parity where pinned
    location: Location = Location()
    hint: str = ""                   # how to fix / what to re-run
    count: int = 1                   # total violations this diag summarizes

    def __str__(self) -> str:
        more = f" (+{self.count - 1} more)" if self.count > 1 else ""
        hint = f" [hint: {self.hint}]" if self.hint else ""
        return (f"{self.code} {self.severity}: {self.message}{more} "
                f"@ {self.location}{hint}")

    def to_json(self) -> dict[str, Any]:
        return {"code": self.code, "severity": str(self.severity),
                "message": self.message, "location": self.location.to_json(),
                "hint": self.hint, "count": self.count}


@dataclasses.dataclass
class VerifyReport:
    """The collected result of one static verification run."""
    diagnostics: list[Diagnostic]
    stats: dict[str, Any]            # checker name -> proven facts
    checkers: list[str]              # checkers that ran, in order
    wall_ms: float
    checker_wall_ms: dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        """True iff no ERROR-severity diagnostic was emitted."""
        return not self.errors

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def to_json(self) -> dict[str, Any]:
        return {
            "ok": self.ok,
            "diagnostics": [d.to_json() for d in self.diagnostics],
            "stats": self.stats,
            "checkers": self.checkers,
            "wall_ms": self.wall_ms,
            "checker_wall_ms": self.checker_wall_ms,
        }

    def summary(self) -> str:
        """Human one-per-line rendering (the CLI's default output)."""
        head = (f"{len(self.diagnostics)} diagnostic(s), "
                f"{len(self.errors)} error(s) "
                f"[{', '.join(self.checkers)}; {self.wall_ms:.1f} ms]")
        if not self.diagnostics:
            return f"clean: 0 diagnostics {head[len('0 diagnostic(s), '):]}"
        return "\n".join([head] + [f"  {d}" for d in self.diagnostics])


# ---------------------------------------------------------------------------
# The stable diagnostic-code registry (DESIGN.md §13).
# ---------------------------------------------------------------------------

CODES: dict[str, str] = {}


def register_code(code: str, title: str) -> str:
    """Register a stable diagnostic code with its one-line meaning.

    Re-registering the same (code, title) pair is a no-op (modules may
    be reloaded); changing the title of an existing code is an error —
    codes are a public contract.
    """
    if code in CODES and CODES[code] != title:
        raise ValueError(f"diagnostic code {code} already registered as "
                         f"{CODES[code]!r}")
    CODES[code] = title
    return code
