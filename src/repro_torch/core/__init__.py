"""Port of :mod:`repro.core`: the graph, the memory and resource models,
the mapping search and partitioners, the baselines, the scheduler, the
compile passes and ``compile``, the artifact, its executors, its cycle
and energy model, and the engine.

This package imports torch and numpy only; nothing here pulls in jax,
and importing it touches no CUDA card (spawned compile workers import
it). The compiler is host numpy; the engine runs on the card.
"""
from repro_torch.core.aot import content_hash, normalize_buckets
# the mapping package first: its strategy registry imports the baselines
from repro_torch.core.mapping import (STRATEGIES, CandidateTrace,
                                      MappingStrategy, PartitionResult,
                                      SearchConfig, SearchTrace,
                                      framework_partition, get_strategy,
                                      portfolio_search, register_strategy)
from repro_torch.core.baselines import (BASELINES, post_neuron_round_robin,
                                        synapse_round_robin,
                                        weight_round_robin)
from repro_torch.core.cost import ResourceModel, ResourceReport, resources
from repro_torch.core.engine import (CycleModel, CycleReport,
                                     MergeAlignmentError, PowerModel,
                                     oracle_packet_counts, packet_stats,
                                     run_mapped, run_oracle)
from repro_torch.core.engine_torch import (TorchMappedEngine,
                                           finalize_outputs,
                                           normalize_ext_spikes)
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph, from_quantized, random_graph
from repro_torch.core.memory_model import (HardwareConfig, bram_count,
                                           scores_from_assignment,
                                           spu_score, spu_usage,
                                           total_memory_bits,
                                           total_memory_kb)
from repro_torch.core.partition import partition
from repro_torch.core.passes import (CompileReport, build_report,
                                     initialization_packets, lower_pass,
                                     partition_pass, schedule_pass,
                                     search_pass, validate_pass)
from repro_torch.core.program import (PROGRAM_FORMAT_VERSION, ProfileReport,
                                      Program, compile)
from repro_torch.core.compiler import compile_quantized, compile_snn
from repro_torch.core.scheduling import (NOP, SCHEDULE_STRATEGIES,
                                         LoweredProgram, OpTables,
                                         ScheduleStrategy,
                                         get_schedule_strategy,
                                         lower_tables,
                                         register_schedule_strategy,
                                         schedule, validate_schedule)

__all__ = [
    "SNNGraph", "from_quantized", "random_graph", "HardwareConfig",
    "spu_score", "spu_usage", "scores_from_assignment", "total_memory_bits",
    "total_memory_kb", "bram_count", "PartitionResult", "partition",
    "BASELINES", "post_neuron_round_robin", "synapse_round_robin",
    "weight_round_robin", "NOP", "LoweredProgram", "OpTables", "lower_tables",
    "schedule", "validate_schedule",
    "SCHEDULE_STRATEGIES", "ScheduleStrategy", "get_schedule_strategy",
    "register_schedule_strategy",
    "CycleModel", "CycleReport", "PowerModel", "MergeAlignmentError",
    "oracle_packet_counts", "packet_stats", "run_mapped", "run_oracle",
    "TorchMappedEngine", "ResourceModel", "ResourceReport", "resources",
    "CandidateTrace", "MappingStrategy", "SearchConfig", "SearchTrace",
    "STRATEGIES", "framework_partition", "get_strategy", "portfolio_search",
    "register_strategy",
    "CompileReport", "build_report", "initialization_packets", "lower_pass",
    "partition_pass", "schedule_pass", "search_pass", "validate_pass",
    "PROGRAM_FORMAT_VERSION", "Program", "ProfileReport", "compile",
    "compile_snn", "compile_quantized",
    "ExecutionSpec", "as_spec", "content_hash", "finalize_outputs",
    "normalize_buckets", "normalize_ext_spikes",
]
