"""Heuristic scheduling (paper §6.3); port of the compatibility shim
``repro/core/schedule.py`` over :mod:`repro_torch.core.scheduling`."""
from repro_torch.core.scheduling import (NOP, LoweredProgram,  # noqa: F401
                                         OpTables, lower_tables, schedule,
                                         validate_schedule)

__all__ = ["NOP", "OpTables", "LoweredProgram", "lower_tables",
           "schedule", "validate_schedule"]
