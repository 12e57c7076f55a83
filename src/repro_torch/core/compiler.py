"""Deprecated compile wrappers (pre-Program API); port of
``repro/core/compiler.py``.

The end-to-end pipeline now lives in :mod:`repro_torch.core.passes` (the
explicit passes) and :mod:`repro_torch.core.program` (the :class:`Program`
artifact). ``compile_snn`` / ``compile_quantized`` remain as thin
delegating wrappers so pre-artifact callers keep working; new code
should call :func:`repro_torch.core.program.compile` and use the artifact::

    program = compile(g, hw)                  # was: compile_snn(g, hw)
    tables, report, part = (program.tables,   # the old 3-tuple
                            program.report, program.part)

``CompileReport`` and ``initialization_packets`` moved to
:mod:`repro_torch.core.passes`; they are re-exported here unchanged.
"""
from __future__ import annotations

import warnings

from repro_torch.core import program as _program
from repro_torch.core.graph import SNNGraph, from_quantized
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.partition import PartitionResult
from repro_torch.core.passes import (CompileReport,  # noqa: F401 (re-export)
                               initialization_packets)
from repro_torch.core.scheduling import OpTables
from repro_torch.snn.quantize import QuantizedSNN


def compile_snn(g: SNNGraph, hw: HardwareConfig, method: str = "framework",
                seed: int = 0, validate: bool = True,
                max_iters: int = 20000, restarts: int = 1
                ) -> tuple[OpTables, CompileReport, PartitionResult]:
    """Deprecated: use :func:`repro_torch.core.program.compile`.

    Same pipeline, same defaults; returns the artifact's parts as the
    historical ``(tables, report, part)`` 3-tuple.
    """
    warnings.warn(
        "compile_snn is deprecated; use repro_torch.core.compile(g, hw, ...) and "
        "the returned Program artifact", DeprecationWarning, stacklevel=2)
    p = _program.compile(g, hw, method=method, seed=seed, validate=validate,
                         max_iters=max_iters, restarts=restarts)
    return p.tables, p.report, p.part


def compile_quantized(qsnn: QuantizedSNN, hw: HardwareConfig, **kw):
    """Deprecated: ``repro_torch.core.compile`` accepts a QuantizedSNN directly."""
    warnings.warn(
        "compile_quantized is deprecated; repro_torch.core.compile accepts a "
        "QuantizedSNN directly", DeprecationWarning, stacklevel=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return compile_snn(from_quantized(qsnn), hw, **kw)
