"""Port of :mod:`repro.core`: the artifact, its executors, its cycle and
energy model, and the engine.

This package imports torch and numpy only; nothing here pulls in jax.
"""
from repro_torch.core.aot import content_hash, normalize_buckets
from repro_torch.core.cost import ResourceModel, ResourceReport
from repro_torch.core.engine import (CycleModel, CycleReport,
                                     MergeAlignmentError, PowerModel,
                                     oracle_packet_counts, packet_stats,
                                     run_mapped, run_oracle)
from repro_torch.core.engine_torch import (TorchMappedEngine,
                                           finalize_outputs,
                                           normalize_ext_spikes)
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping import (CandidateTrace, PartitionResult,
                                      SearchTrace)
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.passes import CompileReport, initialization_packets
from repro_torch.core.program import ProfileReport, Program
from repro_torch.core.scheduling import (NOP, LoweredProgram, OpTables,
                                         lower_tables)

__all__ = [
    "CandidateTrace", "CompileReport", "CycleModel", "CycleReport",
    "ExecutionSpec", "HardwareConfig", "LoweredProgram",
    "MergeAlignmentError", "NOP", "OpTables", "PartitionResult",
    "PowerModel", "ProfileReport", "Program", "ResourceModel",
    "ResourceReport", "SNNGraph", "SearchTrace", "TorchMappedEngine",
    "as_spec", "content_hash", "finalize_outputs",
    "initialization_packets", "lower_tables", "normalize_buckets",
    "normalize_ext_spikes", "oracle_packet_counts", "packet_stats",
    "run_mapped", "run_oracle",
]
