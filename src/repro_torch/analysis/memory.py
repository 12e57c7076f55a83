"""Memory / capacity audit; port of ``repro/analysis/memory.py``.

The persisted :class:`~repro_torch.core.passes.CompileReport` header is
a claim about the artifact. This checker recomputes every one of those
claims from the raw graph and tables arrays and cross-checks the
header:

* MEM001  Eq. 9 per-SPU occupancy overflow on a feasible-claimed
          artifact;
* MEM002  persisted per-SPU scores != recomputed Eq. 10;
* MEM003  persisted per-SPU synapse/post/weight stats != recomputed;
* MEM004  header ``ot_depth`` != the actual table depth;
* MEM005  persisted resource report != the Eq. 11 / BRAM / LUT / FF
          recompute at the actual depth;
* MEM006  header ``n_init_packets`` != the closed-form recompute;
* MEM007  graph exceeds the ``max_neurons`` addressing capacity;
* MEM008  internal neurons exceed the Neuron State SRAM capacity;
* MEM009  header says infeasible but the recomputed scores are all
          non-negative (WARNING).

Everything is recomputed from ``tables.assign``, the mapping that
executes. The core modules are imported inside the checker.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import numpy as np

from repro_torch.analysis.diagnostics import (Diagnostic, Location, Severity,
                                        register_code)

if TYPE_CHECKING:
    from repro_torch.core.program import Program

MEM001 = register_code(
    "MEM001", "Eq. 9 Unified-Memory occupancy overflow on a feasible artifact")
MEM002 = register_code("MEM002", "persisted SPU scores != recomputed Eq. 10")
MEM003 = register_code(
    "MEM003", "persisted per-SPU stats != recomputed from arrays")
MEM004 = register_code("MEM004", "header ot_depth != actual table depth")
MEM005 = register_code(
    "MEM005", "persisted resource report != Eq. 11 recompute")
MEM006 = register_code(
    "MEM006", "header n_init_packets != closed-form recompute")
MEM007 = register_code("MEM007", "graph exceeds max_neurons addressing")
MEM008 = register_code(
    "MEM008", "internal neurons exceed Neuron State SRAM capacity")
MEM009 = register_code(
    "MEM009", "header says infeasible but recomputed scores are clean")


def _first_diff(a: Any, b: Any) -> int:
    d = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(d[0]) if len(d) else -1


def check_memory(program: "Program") -> tuple[list[Diagnostic],
                                              dict[str, Any]]:
    """MEM diagnostics + recomputed memory facts for an artifact."""
    from repro_torch.core.cost import resources
    from repro_torch.core.memory_model import (scores_from_assignment,
                                               total_memory_bits,
                                               usage_from_assignment)
    from repro_torch.core.passes import _spu_stats, n_initialization_packets

    g, hw, tables, rep = (program.graph, program.hw, program.tables,
                          program.report)
    out: list[Diagnostic] = []
    assign = tables.assign

    # -- Eq. 9/10 from the shipped mapping ----------------------------------
    scores = scores_from_assignment(g.weight, g.post, assign, hw)
    usage = usage_from_assignment(g.weight, g.post, assign, hw)
    worst = int(np.argmin(scores)) if len(scores) else 0
    if rep.feasible and len(scores) and int(scores[worst]) < 0:
        out.append(Diagnostic(
            code=MEM001, severity=Severity.ERROR,
            message=(f"SPU {worst} uses {int(usage[worst])} memory lines "
                     f"> depth {hw.unified_mem_depth} (Eq. 9 score "
                     f"{int(scores[worst])}) on a feasible-claimed artifact"),
            location=Location(spu=worst, field="report.feasible"),
            hint="the mapping overflows the Unified Memory; re-partition",
            count=int((scores < 0).sum())))
    if not rep.feasible and len(scores) and int(scores.min()) >= 0:
        out.append(Diagnostic(
            code=MEM009, severity=Severity.WARNING,
            message=("header says infeasible but every recomputed Eq. 10 "
                     f"score is >= 0 (min {int(scores.min())})"),
            location=Location(field="report.feasible"),
            hint="stale conservative header; recompile to refresh"))
    if not np.array_equal(np.asarray(rep.scores), scores):
        i = _first_diff(rep.scores, scores)
        out.append(Diagnostic(
            code=MEM002, severity=Severity.ERROR,
            message=(f"persisted score[{i}]={int(np.asarray(rep.scores)[i])}"
                     f" != recomputed Eq. 10 score {int(scores[i])}"),
            location=Location(spu=i, field="report.scores"),
            hint="stale header (or tables.assign diverged); recompile",
            count=int((np.asarray(rep.scores) != scores).sum())))

    # -- per-SPU stats ------------------------------------------------------
    syn, posts, weights = _spu_stats(g, assign, hw.n_spus)
    for name, have, want in (("spu_synapse_counts", rep.spu_synapse_counts,
                              syn),
                             ("spu_post_counts", rep.spu_post_counts, posts),
                             ("spu_weight_counts", rep.spu_weight_counts,
                              weights)):
        if not np.array_equal(np.asarray(have), want):
            i = _first_diff(have, want)
            out.append(Diagnostic(
                code=MEM003, severity=Severity.ERROR,
                message=(f"persisted {name}[{i}]="
                         f"{int(np.asarray(have)[i])} != recomputed "
                         f"{int(want[i])}"),
                location=Location(spu=i, field=f"report.{name}"),
                hint="stale header; recompile",
                count=int((np.asarray(have) != want).sum())))

    # -- OT depth -----------------------------------------------------------
    if int(rep.ot_depth) != int(tables.depth):
        out.append(Diagnostic(
            code=MEM004, severity=Severity.ERROR,
            message=(f"header ot_depth={int(rep.ot_depth)} != actual table "
                     f"depth {int(tables.depth)}"),
            location=Location(field="report.ot_depth"),
            hint="stale header; recompile"))

    # -- Eq. 11 / BRAM / LUT / FF at the ACTUAL depth -----------------------
    res = resources(hw, int(tables.depth))
    for fld, have, want in (("luts", rep.resources.luts, res.luts),
                            ("ffs", rep.resources.ffs, res.ffs),
                            ("brams", rep.resources.brams, res.brams),
                            ("memory_kb", rep.resources.memory_kb,
                             res.memory_kb)):
        if not math.isclose(float(have), float(want), rel_tol=1e-12,
                            abs_tol=1e-9):
            out.append(Diagnostic(
                code=MEM005, severity=Severity.ERROR,
                message=(f"persisted resources.{fld}={have} != Eq. 11 "
                         f"recompute {want} at depth {int(tables.depth)}"),
                location=Location(field=f"report.resources.{fld}"),
                hint="stale header; recompile"))

    # -- init-packet count --------------------------------------------------
    n_init = n_initialization_packets(g, tables)
    if int(rep.n_init_packets) != n_init:
        out.append(Diagnostic(
            code=MEM006, severity=Severity.ERROR,
            message=(f"header n_init_packets={int(rep.n_init_packets)} != "
                     f"recomputed stream length {n_init}"),
            location=Location(field="report.n_init_packets"),
            hint="stale header; recompile"))

    # -- per-chip capacity bounds -------------------------------------------
    if g.n_neurons > hw.max_neurons:
        out.append(Diagnostic(
            code=MEM007, severity=Severity.ERROR,
            message=(f"{g.n_neurons} neurons exceed the max_neurons="
                     f"{hw.max_neurons} addressing capacity"),
            location=Location(field="hw.max_neurons"),
            hint="raise max_neurons (wider routing words) or shrink the net"))
    nu_capacity = hw.n_chips * hw.max_post_neurons
    if g.n_internal > nu_capacity:
        out.append(Diagnostic(
            code=MEM008, severity=Severity.ERROR,
            message=(f"{g.n_internal} internal neurons exceed the Neuron "
                     f"State SRAM capacity {nu_capacity} "
                     f"({hw.n_chips} chip(s) x max_post_neurons="
                     f"{hw.max_post_neurons})"),
            location=Location(field="hw.max_post_neurons"),
            hint="raise max_post_neurons or scale out n_chips"))

    stats: dict[str, Any] = {
        "score_min": int(scores.min()) if len(scores) else 0,
        "usage_max": int(usage.max()) if len(usage) else 0,
        "unified_mem_depth": int(hw.unified_mem_depth),
        "ot_depth": int(tables.depth),
        "total_memory_bits": int(total_memory_bits(hw, int(tables.depth))),
        "memory_kb": float(res.memory_kb),
        "brams": float(res.brams),
        "n_init_packets": int(n_init),
        "feasible": bool(rep.feasible),
    }
    return out, stats
