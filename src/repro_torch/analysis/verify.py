"""The verifier's entry point, ``verify(program) -> VerifyReport``, and
its CLI; port of ``repro/analysis/verify.py``.

Runs every registered checker over a compiled
:class:`~repro_torch.core.program.Program` without executing any
engine. The built-in pipeline is

1. ``artifact``: well-formedness of the raw arrays (ART001-003); any
   ERROR here gates the remaining checkers, which index those arrays;
2. ``schedule``: the hazard detector of
   :mod:`repro_torch.analysis.schedule` (SCHED001-009);
3. ``ranges``: the integer range analysis of
   :mod:`repro_torch.analysis.ranges` (RANGE001-002, proven bounds in
   ``report.stats['ranges']``);
4. ``memory``: the Eq. 9/11 capacity audit of
   :mod:`repro_torch.analysis.memory` (MEM001-009).

:func:`register_checker` extends the pipeline; :func:`verify` refuses
diagnostics whose code is not in
:data:`~repro_torch.analysis.diagnostics.CODES`.

CLI::

    python -m repro_torch.analysis.verify artifact.npz [more.npz ...] \
        [--json] [--strict]

Exit status: 0 clean, 1 on any ERROR diagnostic (``--strict``: on ANY
diagnostic), 2 on an unreadable artifact. ``--json`` prints the
reference's JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.analysis.diagnostics import (CODES, Diagnostic, Location,
                                        Severity, VerifyReport,
                                        register_code)

if TYPE_CHECKING:
    from repro_torch.core.program import Program

Checker = Callable[["Program"], "tuple[list[Diagnostic], dict[str, Any]]"]

ART001 = register_code("ART001", "malformed artifact arrays")
ART002 = register_code("ART002", "graph invariant violation")
ART003 = register_code(
    "ART003", "hardware config inconsistent with the artifact")


def _art(code: str, message: str, hint: str = "", count: int = 1,
         **loc: Any) -> Diagnostic:
    return Diagnostic(code=code, severity=Severity.ERROR, message=message,
                      location=Location(**loc), hint=hint, count=count)


def check_artifact(program: "Program") -> tuple[list[Diagnostic],
                                                dict[str, Any]]:
    """ART diagnostics: raw-array well-formedness of the artifact."""
    import numpy as np

    g, hw, tables = program.graph, program.hw, program.tables
    out: list[Diagnostic] = []

    # -- ART001: table/graph array shapes ------------------------------------
    shape = tables.pre.shape
    for name, arr in (("post", tables.post), ("weight", tables.weight),
                      ("pre_end", tables.pre_end),
                      ("post_end", tables.post_end)):
        if arr.shape != shape:
            out.append(_art(
                ART001, f"tables.{name} shape {arr.shape} != tables.pre "
                        f"shape {shape}", field=f"tables.{name}",
                hint="artifact arrays are torn; re-save from compile()"))
    if len(shape) != 2 or int(tables.depth) != shape[1]:
        out.append(_art(
            ART001, f"tables.depth={int(tables.depth)} != array depth "
                    f"{shape[1] if len(shape) == 2 else shape}",
            field="tables.depth",
            hint="artifact arrays are torn; re-save from compile()"))
    if not (g.pre.shape == g.post.shape == g.weight.shape):
        out.append(_art(
            ART001, f"graph arrays disagree: pre {g.pre.shape}, post "
                    f"{g.post.shape}, weight {g.weight.shape}",
            field="graph", hint="re-save from compile()"))
    if tables.assign.shape != g.pre.shape:
        out.append(_art(
            ART001, f"tables.assign has {tables.assign.shape[0]} entries "
                    f"for {g.n_synapses} synapses", field="tables.assign",
            hint="the partition must assign every synapse exactly once"))

    # -- ART002: graph invariants (mirrors SNNGraph.validate) ----------------
    n, ni = int(g.n_neurons), int(g.n_inputs)
    checks = [
        ((g.weight == 0), "zero-weight synapse (must be dropped)"),
        ((g.pre < 0) | (g.pre >= n), f"pre index outside [0, {n})"),
        ((g.post < ni) | (g.post >= n),
         f"post index outside [{ni}, {n}) (must be internal)"),
    ]
    for bad, what in checks:
        if bad.any():
            i = int(np.argmax(bad))
            out.append(_art(
                ART002, f"synapse {i}: {what} (pre={int(g.pre[i])}, "
                        f"post={int(g.post[i])}, w={int(g.weight[i])})",
                count=int(bad.sum()), pre=int(g.pre[i]), post=int(g.post[i]),
                hint="the graph violates SNNGraph invariants; rebuild it"))
    key = g.pre.astype(np.int64) * n + g.post
    uniq, counts = np.unique(key, return_counts=True)
    if (counts > 1).any():
        k = int(uniq[np.argmax(counts > 1)])
        out.append(_art(
            ART002, f"duplicate synapse ({k // n} -> {k % n})",
            count=int((counts > 1).sum()), pre=k // n, post=k % n,
            hint="merge duplicate (pre, post) pairs before compiling"))

    # -- ART003: hw vs artifact ----------------------------------------------
    if tables.n_spus != hw.n_spus:
        out.append(_art(
            ART003, f"tables span {tables.n_spus} SPUs but hw.n_spus="
                    f"{hw.n_spus}", field="hw.n_spus",
            hint="the artifact was scheduled for a different fabric"))
    if len(tables.assign) and tables.assign.size and (
            (tables.assign < 0).any()
            or (tables.assign >= hw.n_spus).any()):
        i = int(np.argmax((tables.assign < 0)
                          | (tables.assign >= hw.n_spus)))
        out.append(_art(
            ART003, f"tables.assign[{i}]={int(tables.assign[i])} outside "
                    f"[0, {hw.n_spus})", field="tables.assign",
            hint="the partition names SPUs the hardware does not have"))

    stats = {"n_synapses": int(g.n_synapses), "n_neurons": n,
             "n_spus": int(tables.n_spus), "depth": int(tables.depth)}
    return out, stats


def _schedule_checker(program: "Program") -> tuple[list[Diagnostic],
                                                   dict[str, Any]]:
    from repro_torch.analysis.schedule import check_schedule
    diags = check_schedule(program.graph, program.tables)
    return diags, {"n_sends": len(program.tables.send_slot)}


def _ranges_checker(program: "Program") -> tuple[list[Diagnostic],
                                                 dict[str, Any]]:
    from repro_torch.analysis.ranges import check_ranges
    return check_ranges(program.graph, program.hw, program.tables)


def _memory_checker(program: "Program") -> tuple[list[Diagnostic],
                                                 dict[str, Any]]:
    from repro_torch.analysis.memory import check_memory
    return check_memory(program)


# ordered registry; "artifact" gates the rest (its ERRORs mean the
# arrays cannot be safely indexed by the other checkers)
CHECKERS: dict[str, Checker] = {
    "artifact": check_artifact,
    "schedule": _schedule_checker,
    "ranges": _ranges_checker,
    "memory": _memory_checker,
}
_GATE = "artifact"


def register_checker(name: str, fn: Checker) -> None:
    """Add a checker to the verification pipeline (runs after the
    built-ins, in registration order). The checker must only emit
    diagnostics with :func:`register_code`-registered codes."""
    if name in CHECKERS:
        raise ValueError(f"checker {name!r} already registered")
    CHECKERS[name] = fn


def verify(program: "Program",
           checkers: "list[str] | None" = None) -> VerifyReport:
    """Statically verify a compiled artifact; never executes an engine.

    ``checkers`` restricts the run to a subset of registry names
    (default: all, in registry order). Raises ``KeyError`` on unknown
    names and ``ValueError`` if a checker emits an unregistered code.
    """
    names = list(CHECKERS) if checkers is None else list(checkers)
    for name in names:
        if name not in CHECKERS:
            raise KeyError(f"unknown checker {name!r}; registered: "
                           f"{sorted(CHECKERS)}")
    t0 = time.perf_counter()
    diags: list[Diagnostic] = []
    stats: dict[str, Any] = {}
    ran: list[str] = []
    per_ms: dict[str, float] = {}
    gated = False
    for name in names:
        if gated and name != _GATE:
            continue
        t1 = time.perf_counter()
        d, s = CHECKERS[name](program)
        per_ms[name] = (time.perf_counter() - t1) * 1e3
        for diag in d:
            if diag.code not in CODES:
                raise ValueError(
                    f"checker {name!r} emitted unregistered code "
                    f"{diag.code!r}; call analysis.register_code first")
        diags.extend(d)
        stats[name] = s
        ran.append(name)
        if name == _GATE and any(x.severity >= Severity.ERROR for x in d):
            gated = True                # arrays unsafe for the others
    return VerifyReport(diagnostics=diags, stats=stats, checkers=ran,
                        wall_ms=(time.perf_counter() - t0) * 1e3,
                        checker_wall_ms=per_ms)


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------

def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description="Statically verify compiled SupraSNN Program artifacts "
                    "(no engine execution).")
    ap.add_argument("paths", nargs="+", help="Program .npz artifact(s)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON object {path: report} to stdout")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on ANY diagnostic (default: errors only)")
    args = ap.parse_args(argv)

    from repro_torch.core.program import Program
    reports: dict[str, VerifyReport] = {}
    status = 0
    for path in args.paths:
        try:
            program = Program.load(path)
        except Exception as e:           # unreadable beats unverifiable
            print(f"{path}: cannot load: {e}", file=sys.stderr)
            return 2
        rep = verify(program)
        reports[path] = rep
        bad = rep.diagnostics if args.strict else rep.errors
        if bad:
            status = 1
        if not args.as_json:
            print(f"{path}: {rep.summary()}")
    if args.as_json:
        print(json.dumps({p: r.to_json() for p, r in reports.items()},
                         indent=2, sort_keys=True))
    return status


if __name__ == "__main__":
    sys.exit(main())
