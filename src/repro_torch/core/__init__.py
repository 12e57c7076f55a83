"""Port of :mod:`repro.core`: the artifact, its lowering and the engine.

This package imports torch and numpy only; nothing here pulls in jax.
"""
from repro_torch.core.engine import packet_stats
from repro_torch.core.engine_torch import (TorchMappedEngine,
                                           finalize_outputs,
                                           normalize_ext_spikes)
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.program import Program
from repro_torch.core.scheduling import (NOP, LoweredProgram, OpTables,
                                         lower_tables)

__all__ = [
    "ExecutionSpec", "HardwareConfig", "LoweredProgram", "NOP", "OpTables",
    "Program", "SNNGraph", "TorchMappedEngine", "as_spec",
    "finalize_outputs", "lower_tables", "normalize_ext_spikes",
    "packet_stats",
]
