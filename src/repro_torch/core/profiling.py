"""Compile-phase profiler (DESIGN.md §12); port of
``repro/core/profiling.py``.

The compile pipeline is a handful of named passes, but at compiler
scale (10⁵–10⁶ synapses) the interesting costs live INSIDE one of them
— the multilevel partitioner's coarsen / coarse-search / project /
refine stages. A :class:`PhaseProfiler` accumulates wall seconds (and
optionally allocation deltas) per named phase; the active profiler is
carried in a :class:`contextvars.ContextVar` so deeply nested stages
record phases without threading a profiler argument through every
mapping-strategy signature.

Usage::

    with profiled(PhaseProfiler()) as prof:
        ...                         # any code calling phase("name")
    prof.seconds                    # {"coarsen": 0.07, "refine": 0.61, ...}

``phase("name")`` is a no-op context manager when no profiler is
active, so instrumented code costs nothing in un-profiled runs.
Phases may repeat and nest; repeated entries accumulate, nested phases
are recorded under their own names (the compile pipeline's top-level
pass phases — ``partition``/``schedule``/``validate``/``lower``/
``report`` — contain the partitioner's sub-phases, so summing ONLY the
top-level keys gives the pipeline total).
"""
from __future__ import annotations

import contextlib
import contextvars
import time
import tracemalloc

#: the compile pipeline's top-level pass phases; they tile the whole
#: compile, so their sum approximates ``CompileReport.compile_seconds``
#: (sub-phases like ``coarsen``/``refine`` nest inside ``partition``)
TOP_LEVEL_PHASES = ("partition", "schedule", "validate", "lower", "report")


class PhaseProfiler:
    """Accumulates per-phase wall seconds (and, optionally, allocation).

    ``alloc=True`` additionally records each phase's net allocation
    delta and in-phase peak, in MB, via :mod:`tracemalloc` (started by
    :func:`profiled` if not already tracing) — useful for attributing
    the compiler's RSS, at a 2–4x wall-clock cost.
    """

    def __init__(self, *, alloc: bool = False):
        self.alloc = alloc
        self.seconds: dict[str, float] = {}
        self.alloc_mb: dict[str, float] = {}
        self.peak_mb: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.alloc:
            tracemalloc.reset_peak()
            base, _ = tracemalloc.get_traced_memory()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self.alloc:
                cur, peak = tracemalloc.get_traced_memory()
                mb = 1024.0 * 1024.0
                self.alloc_mb[name] = (self.alloc_mb.get(name, 0.0)
                                       + (cur - base) / mb)
                self.peak_mb[name] = max(self.peak_mb.get(name, 0.0),
                                         peak / mb)


_ACTIVE: contextvars.ContextVar[PhaseProfiler | None] = \
    contextvars.ContextVar("suprasnn_phase_profiler", default=None)


def current_profiler() -> PhaseProfiler | None:
    """The profiler installed by the innermost :func:`profiled`, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def profiled(profiler: PhaseProfiler | None = None):
    """Install ``profiler`` (a fresh wall-only one if omitted) as the
    active profiler for the dynamic extent of the block."""
    prof = profiler if profiler is not None else PhaseProfiler()
    started_tracing = False
    if prof.alloc and not tracemalloc.is_tracing():
        tracemalloc.start()
        started_tracing = True
    token = _ACTIVE.set(prof)
    try:
        yield prof
    finally:
        _ACTIVE.reset(token)
        if started_tracing:
            tracemalloc.stop()


class _NullPhase:
    """Shared no-op context manager: ``phase()`` without an active
    profiler must cost nothing (no generator frame, no allocation)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


def phase(name: str):
    """Record a named phase on the active profiler (no-op when none)."""
    prof = _ACTIVE.get()
    return _NULL_PHASE if prof is None else prof.phase(name)
