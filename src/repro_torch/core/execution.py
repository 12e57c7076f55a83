"""ExecutionSpec: one frozen value naming how a Program executes; port of
``repro/core/execution.py``.

* ``engine`` — ``"torch"``, the batched engine
  (:class:`~repro_torch.core.engine_torch.TorchMappedEngine`). The
  reference's ``"python"`` and ``"oracle"`` executors are not ported
  yet (ROADMAP Queue A item 3);
* ``kernel`` — the tier: ``"fused"`` (the whole timestep in one CUDA
  kernel, :mod:`repro_torch.kernels.fused_step`), ``"lif"``
  (index_add segment-sum + the CUDA LIF kernel), ``"reference"`` (plain
  torch). ``None`` resolves to ``"fused"``;
* ``device`` — where the engine runs. ``None`` resolves to the card;
  without one, resolving raises and names ``device="cpu"``. It takes
  the place of the reference's ``interpret`` knob: on the CPU the
  kernels' plain versions run, on CUDA the kernels.

The reference's ``mesh``/``donate`` fields and its deprecated-kwarg
shims are not ported. :meth:`ExecutionSpec.resolve` folds the defaults
in once; the resolved spec is the engine cache key of
``Program.engine()``. All tiers are bit-exact.
"""
from __future__ import annotations

import dataclasses

import torch

ENGINES = ("torch",)
KERNELS = ("fused", "lif", "reference")
# reference engine names and where they stand in the port
_ENGINE_NOTES = {
    "jax": "the port's compiled engine is 'torch'",
    "python": "not ported yet (ROADMAP Queue A item 3)",
    "oracle": "not ported yet (ROADMAP Queue A item 3)",
}


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How to execute a compiled :class:`~repro_torch.core.program.Program`."""
    engine: str = "torch"
    kernel: str | None = None          # None -> "fused"
    device: str | None = None          # None -> the CUDA card

    def __post_init__(self):
        if self.engine not in ENGINES:
            note = _ENGINE_NOTES.get(self.engine)
            raise ValueError(f"unknown engine {self.engine!r}; use one of "
                             f"{ENGINES}" + (f" ({note})" if note else ""))
        if self.kernel is not None and self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; use one of "
                             f"{KERNELS} (or None for the default)")

    def resolve(self) -> "ExecutionSpec":
        """Fold the defaults in: kernel ``"fused"``, device the card.

        Raises ``RuntimeError`` when the spec names the card (or leaves
        the device to default) and no CUDA device is present. Idempotent.
        """
        kernel = self.kernel if self.kernel is not None else "fused"
        return dataclasses.replace(self, kernel=kernel,
                                   device=str(resolve_device(self.device)))


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Where an entry point of the port runs: ``None`` is the card.

    Raises ``RuntimeError``, naming ``device="cpu"``, when the device is
    the card (or left to default) and no CUDA device is present; a CUDA
    device without an index gets the current one.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "device=\"cpu\" to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: the port runs on 'cuda' or "
                         f"'cpu'")
    return dev


def as_spec(spec: "ExecutionSpec | str | None",
            default_engine: str = "torch") -> ExecutionSpec:
    """Coerce the ``spec`` argument of the run surface.

    ``None`` -> the artifact's default engine; a string is shorthand for
    ``ExecutionSpec(engine=<string>)``.
    """
    if spec is None:
        return ExecutionSpec(engine=default_engine)
    if isinstance(spec, str):
        return ExecutionSpec(engine=spec)
    if not isinstance(spec, ExecutionSpec):
        raise TypeError(f"spec must be an ExecutionSpec, engine-name "
                        f"string, or None; got {type(spec).__name__}")
    return spec
