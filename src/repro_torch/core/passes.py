"""The compile pipeline's report and the initialization stream; port of
``CompileReport`` and ``initialization_packets`` from
``repro/core/passes.py``. The passes themselves (partition, schedule,
validate, build_report) wait for the compiler slice (ROADMAP Queue A
item 7); a loaded artifact carries its report in the header.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost import ResourceReport
from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.search import SearchTrace
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling import NOP, OpTables


@dataclasses.dataclass
class CompileReport:
    """Summary of one compile-pipeline run (paper Fig. 8 outputs)."""
    method: str
    feasible: bool
    iterations: int
    perturbations: int
    ot_depth: int
    scores: np.ndarray
    spu_synapse_counts: np.ndarray
    spu_post_counts: np.ndarray          # post-neurons stored per SPU
    spu_weight_counts: np.ndarray        # unique weights per SPU
    resources: ResourceReport
    n_init_packets: int
    compile_seconds: float
    search: SearchTrace | None = None    # portfolio trace (search= compiles)
    candidates_tried: int = 1            # mappings evaluated to pick this one
    schedule_method: str = "slack"       # the ScheduleStrategy that won
    # OT depth under every strategy evaluated for the chosen mapping
    schedule_depths: dict | None = None
    # per-phase wall seconds of the compile-phase profiler; None when
    # profiling was disabled
    phase_seconds: dict | None = None
    # per-phase net allocation MB (None unless an alloc profiler ran)
    phase_alloc_mb: dict | None = None


def initialization_packets(g: SNNGraph, tables: OpTables,
                           hw: HardwareConfig,
                           routing: np.ndarray | None = None
                           ) -> list[tuple[int, int]]:
    """MC-tree initialization stream (paper §4.3, Table 1).

    ctrl=10 selects a unit; ctrl=11 carries its data words. Returns the
    abstract (ctrl, payload) list — its length drives init latency.
    ``routing`` takes the precomputed [n_neurons, n_spus] bitmap (e.g.
    ``lowered.routing``); built here when omitted.
    """
    pkts: list[tuple[int, int]] = []
    m = tables.n_spus
    if routing is None:
        routing = np.zeros((g.n_neurons, m), bool)
        routing[g.pre, tables.assign] = True
    # routing bitstrings (unit id 0 = Routing Unit): one packed-bits
    # matvec per 32-SPU chunk
    pkts.append((0b10, 0))
    chunks = [(int(c), routing[:, c:c + 32].astype(np.int64)
               @ (np.int64(1) << np.arange(min(32, m - c), dtype=np.int64)))
              for c in range(0, m, 32)]
    pkts.extend(
        (0b11, sum(int(word[q]) << shift for shift, word in chunks))
        for q in range(g.n_neurons))
    # per-SPU operation tables + unified memories (unit ids 1..M)
    for i in range(m):
        pkts.append((0b10, 1 + i))
        for t in range(tables.depth):
            pkts.append((0b11, int(tables.pre[i, t])))
        used_w = np.unique(tables.weight[i][tables.pre[i] != NOP])
        for w in used_w:
            pkts.append((0b11, int(w)))
    # neuron unit (unit id M+1): global index + flags per internal neuron
    pkts.append((0b10, 1 + m))
    for q in range(g.n_inputs, g.n_neurons):
        pkts.append((0b11, q))
    return pkts
