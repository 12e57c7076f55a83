"""Port of :mod:`repro.core.scheduling`: the table containers and lowering.
The scheduling strategies wait for the compiler slice."""
from repro_torch.core.scheduling.tables import (NOP, LoweredProgram,
                                                OpTables, lower_tables)

__all__ = ["NOP", "LoweredProgram", "OpTables", "lower_tables"]
