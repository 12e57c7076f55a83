"""Static analysis over compiled SupraSNN artifacts; port of
:mod:`repro.analysis`, numpy only.

``verify(program)`` proves the paper's architectural contract (schedule
legality, integer ranges, Eq. 9/11 memory bounds) on a loaded
:class:`~repro_torch.core.program.Program` without executing any
engine, and reports violations as structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records with the
reference's codes and messages. Entry points:
:meth:`repro_torch.core.program.Program.verify`, the ``python -m
repro_torch.analysis.verify`` CLI, and the
``ProgramRegistry.register(verify=True)`` serving gate.
"""
from typing import Any

from repro_torch.analysis.diagnostics import (CODES, Diagnostic, Location,
                                              Severity, VerifyReport,
                                              register_code)

__all__ = ["CODES", "CHECKERS", "Diagnostic", "Location", "Severity",
           "VerifyReport", "register_code", "register_checker", "verify"]

_LAZY = {"verify", "register_checker", "CHECKERS"}


def __getattr__(name: str) -> Any:
    # verify.py loads lazily (PEP 562), so `python -m
    # repro_torch.analysis.verify` does not import it twice (as part of
    # the package and as __main__). The resolved attributes are pinned
    # into the package namespace, so `repro_torch.analysis.verify` stays
    # the FUNCTION although the submodule import bound the module there.
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("repro_torch.analysis.verify")
        for n in _LAZY:
            globals()[n] = getattr(mod, n)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
