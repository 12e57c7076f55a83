"""Schedule legality checks; port of
``repro/core/scheduling/validate.py``.

The analysis lives in :mod:`repro_torch.analysis.schedule` (the
verifier's schedule hazard detector); :func:`validate_schedule` runs it
and raises ``AssertionError`` with the reference's message for the
highest-priority violation.
"""
from __future__ import annotations

from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling.tables import OpTables


def validate_schedule(g: SNNGraph, tables: OpTables) -> None:
    """Legality checks: raises AssertionError on the first violation
    (the reference's check order and message); use
    :func:`repro_torch.analysis.schedule.check_schedule` for the full
    structured diagnostic list."""
    # lazy: the analysis layer sits above the scheduling layer
    from repro_torch.analysis.schedule import check_schedule, raise_legacy
    raise_legacy(check_schedule(g, tables))
