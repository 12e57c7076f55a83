"""The compile pipeline as explicit passes; port of
``repro/core/passes.py``::

    partition (or search) -> schedule -> validate -> lower -> report

:func:`repro_torch.core.program.compile` assembles them into a
:class:`~repro_torch.core.program.Program`. Each pass is a pure function
of its inputs: re-schedule a hand-edited assignment, or lower a baseline
for comparison. This module also owns :class:`CompileReport` and
:func:`initialization_packets` (the MC-tree configuration stream).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost import ResourceReport, resources
from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.search import (SearchConfig, SearchTrace,
                                             portfolio_search)
from repro_torch.core.mapping.strategies import get_strategy
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling import (NOP, LoweredProgram, OpTables,
                                         lower_tables, schedule,
                                         validate_schedule)


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


# ---------------------------------------------------------------------------
# Passes.
# ---------------------------------------------------------------------------

def partition_pass(g: SNNGraph, hw: HardwareConfig, *,
                   method: str = "framework", seed: int = 0,
                   max_iters: int = 20000, restarts: int = 1,
                   workers: int = 1) -> PartitionResult:
    """Synapse -> SPU assignment (paper §6.2, or a round-robin baseline).

    ``method`` names a registered
    :class:`~repro_torch.core.mapping.strategies.MappingStrategy`:
    ``'framework'`` is the probabilistic search (vectorized over up to
    ``restarts`` lockstep seeds, keeping the first feasible / best
    worst-SPU score); the :data:`repro_torch.core.baselines.BASELINES`
    keys select those baselines. Unknown names raise ``ValueError``
    listing the registry. ``workers > 1`` lets strategies with internal
    candidate races (``multilevel`` coarse seeds) fan out over spawned
    processes; results are worker-count-invariant.
    """
    return get_strategy(method).partition(g, hw, seed=seed,
                                          max_iters=max_iters,
                                          restarts=restarts,
                                          workers=workers)


def search_pass(g: SNNGraph, hw: HardwareConfig,
                config: SearchConfig | None = None
                ) -> tuple[PartitionResult, SearchTrace, OpTables | None]:
    """Portfolio mapping search (``compile(search=...)``): the framework
    restart population raced against every baseline; returns the best
    (feasible, min OT depth, min memory) candidate, the per-candidate
    :class:`~repro_torch.core.mapping.search.SearchTrace`, and the
    winner's already-scheduled tables (None if infeasible)."""
    return portfolio_search(g, hw, config)


def schedule_pass(g: SNNGraph, part: PartitionResult | np.ndarray,
                  hw: HardwareConfig, *, method: str = "slack") -> OpTables:
    """Heuristic scheduling (paper §6.3) of an assignment into OpTables.

    ``method`` names a registered
    :class:`~repro_torch.core.scheduling.strategies.ScheduleStrategy`
    (the post transmit-order policy); ``'slack'`` is the default.
    """
    assign = part.assign if isinstance(part, PartitionResult) else part
    return schedule(g, assign, hw, method=method)


def validate_pass(g: SNNGraph, tables: OpTables) -> None:
    """Schedule legality checks; raises AssertionError on violation.

    The hazard detector of :mod:`repro_torch.analysis.schedule` computes
    every diagnostic and the highest-priority one is raised with the
    reference's message (an explicit raise, so it holds under
    ``python -O``); see :func:`~repro_torch.core.scheduling
    .validate_schedule`.
    """
    validate_schedule(g, tables)


def lower_pass(g: SNNGraph, tables: OpTables) -> LoweredProgram:
    """Lower OpTables to the dense slot-major program the engines run."""
    return lower_tables(g, tables)


def _spu_stats(g: SNNGraph, assign: np.ndarray, m: int):
    # unique (spu, value) pair counts, one np.unique per attribute
    syn = np.bincount(assign, minlength=m).astype(np.int64)
    posts = np.zeros(m, np.int64)
    weights = np.zeros(m, np.int64)
    a = assign.astype(np.int64)
    for arr, out in ((g.post, posts), (g.weight, weights)):
        vals, inv = np.unique(arr, return_inverse=True)
        if not len(vals):
            continue
        pairs = np.unique(a * len(vals) + inv)
        np.add.at(out, pairs // len(vals), 1)
    return syn, posts, weights


def build_report(g: SNNGraph, hw: HardwareConfig, tables: OpTables,
                 part: PartitionResult, *, method: str,
                 compile_seconds: float,
                 routing: np.ndarray | None = None,
                 search: SearchTrace | None = None,
                 schedule_method: str = "slack",
                 schedule_depths: dict | None = None) -> CompileReport:
    """Assemble the :class:`CompileReport` for a finished pipeline run."""
    syn, posts, weights = _spu_stats(g, part.assign, hw.n_spus)
    return CompileReport(
        method=method, feasible=part.feasible, iterations=part.iterations,
        perturbations=part.perturbations, ot_depth=tables.depth,
        scores=part.scores, spu_synapse_counts=syn, spu_post_counts=posts,
        spu_weight_counts=weights, resources=resources(hw, tables.depth),
        n_init_packets=n_initialization_packets(g, tables),
        compile_seconds=compile_seconds,
        search=search,
        candidates_tried=len(search.candidates) if search else 1,
        schedule_method=schedule_method,
        schedule_depths=(schedule_depths if schedule_depths is not None
                         else {schedule_method: int(tables.depth)}))


# ---------------------------------------------------------------------------
# Initialization stream of the compiled artifact.
# ---------------------------------------------------------------------------

def n_initialization_packets(g: SNNGraph, tables: OpTables) -> int:
    """Length of :func:`initialization_packets` without materializing
    the stream. Closed form: one select + ``n_neurons`` routing words,
    per SPU one select + ``depth`` OT words + its used-weight words, one
    select + ``n_internal`` Neuron Unit words.
    """
    mask = tables.pre != NOP                      # [M, depth]
    w = tables.weight.astype(np.int64)
    span = int(w.max(initial=0)) - int(w.min(initial=0)) + 1
    i_idx = np.nonzero(mask)[0]
    keys = np.unique(i_idx * span + (w[mask] - int(w.min(initial=0))))
    used_w = int(len(keys))
    m = tables.n_spus
    return (1 + g.n_neurons
            + m * (1 + int(tables.depth)) + used_w
            + 1 + (g.n_neurons - g.n_inputs))


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
