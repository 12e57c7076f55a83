"""Artifact registry: N loaded ``Program``\\ s keyed by name; port of
``repro/serve/registry.py``.

A serving process loads each artifact once and registers it under a
unique name. Engines stay per model: they live on each ``Program``,
keyed on the resolved :class:`~repro_torch.core.execution.ExecutionSpec`,
so two models never share an engine and re-resolving a runner reuses
the same one. ``register``/``load`` take ``precompile=`` (a
``BatchPolicy`` or iterable of batch buckets, with ``timesteps=``) and
prepare every serving shape before the model takes its first request:
on the card the ``"fused"`` and ``"lif"`` tiers capture each shape's
T-step loop as a CUDA graph (``Program.precompile``). A runner for an
``ExecutionSpec(mesh=...)`` is the program's owned sharded runner
(:mod:`repro_torch.serve.sharded`). The reference's deprecated kwargs
are not ported.
"""
from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.program import Program

if TYPE_CHECKING:                          # pragma: no cover
    from repro_torch.serve.batcher import BatchPolicy


class ProgramRegistry:
    """Name -> loaded :class:`~repro_torch.core.program.Program`."""

    def __init__(self):
        self._programs: dict[str, Program] = {}
        self._policies: dict[str, "BatchPolicy"] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, program: Program, *, precompile=None,
                 timesteps: int | None = None,
                 spec: ExecutionSpec | None = None,
                 verify: bool = False,
                 policy: "BatchPolicy | None" = None) -> Program:
        """Register a loaded program; duplicate names are rejected.

        ``precompile=`` prepares the given batch buckets (``timesteps``
        fixing the T axis) for ``spec`` at insert time: one CUDA graph
        per bucket on the card (``Program.precompile``). ``policy=``
        attaches the model's serving ``BatchPolicy``. ``verify=True``
        statically verifies the artifact first (:meth:`Program.verify`)
        and rejects it with ``ValueError`` listing the diagnostics if a
        checker reports an ERROR, before any precompile.
        """
        if not name:
            raise ValueError("model name must be non-empty")
        if name in self._programs:
            raise ValueError(f"model {name!r} already registered; "
                             "unregister it first to replace")
        if verify:
            report = program.verify()
            if not report.ok:
                raise ValueError(
                    f"model {name!r} failed static verification with "
                    f"{len(report.errors)} error(s):\n"
                    + "\n".join(f"  {d}" for d in report.errors))
        if precompile is not None:
            if timesteps is None:
                raise ValueError("register(precompile=...) needs timesteps= "
                                 "to fix the T axis of the warmed shapes")
            program.precompile(precompile, timesteps, spec)
        self._programs[name] = program
        if policy is not None:
            self._policies[name] = policy
        return program

    def load(self, name: str, path: str | Path, *, precompile=None,
             timesteps: int | None = None,
             spec: ExecutionSpec | None = None,
             verify: bool = False,
             policy: "BatchPolicy | None" = None) -> Program:
        """``Program.load`` an artifact and register it under ``name``
        (statically verifying it first when ``verify=True``)."""
        return self.register(name, Program.load(path),
                             precompile=precompile, timesteps=timesteps,
                             spec=spec, verify=verify, policy=policy)

    def unregister(self, name: str) -> Program:
        if name not in self._programs:
            raise KeyError(f"model {name!r} not registered")
        self._policies.pop(name, None)
        return self._programs.pop(name)

    def policy(self, name: str) -> "BatchPolicy | None":
        """The serving policy registered with the model, if any."""
        self.get(name)                     # KeyError on unknown names
        return self._policies.get(name)

    # -- lookup -------------------------------------------------------------

    def get(self, name: str) -> Program:
        try:
            return self._programs[name]
        except KeyError:
            raise KeyError(f"model {name!r} not registered; have "
                           f"{self.names()}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._programs))

    def __contains__(self, name: str) -> bool:
        return name in self._programs

    def __len__(self) -> int:
        return len(self._programs)

    # -- per-model runners --------------------------------------------------

    def runner(self, name: str, spec: ExecutionSpec | None = None):
        """The model's batch-callable: ``[b, T, n_in] -> (s, v, stats)``.

        Resolves to the program's owned engine (or owned sharded runner
        when ``spec.mesh`` is set) — repeated calls reuse the same
        object, and distinct models own distinct engines. The returned
        callable carries a ``precompile(buckets, timesteps)`` hook (the
        bound methods' owners have one) for warming.
        """
        program = self.get(name)
        if spec is None:
            return program.run              # default-spec bound method
        spec = as_spec(spec)
        if spec.sharded:
            return program.sharded_runner(spec).run

        def call(ext):
            return program.run(ext, spec)

        def precompile(batch_sizes, timesteps):
            return program.precompile(batch_sizes, timesteps, spec)

        call.precompile = precompile
        return call
