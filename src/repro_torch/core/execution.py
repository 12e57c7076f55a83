"""ExecutionSpec: one frozen value naming how a Program executes; port of
``repro/core/execution.py``.

* ``engine`` — ``"torch"``, the batched engine
  (:class:`~repro_torch.core.engine_torch.TorchMappedEngine`);
  ``"oracle"``, the dense integer LIF
  (:func:`~repro_torch.core.engine.run_oracle`), on the device like
  ``"torch"``; ``"python"``, the structure-faithful host simulator
  (:func:`~repro_torch.core.engine.run_mapped`), which runs on the CPU
  only and so must be asked for with ``device="cpu"``: it never stands
  in on the host for a card the caller asked for (or left to default);
* ``kernel`` — the ``"torch"`` engine's tier: ``"fused"`` (the whole
  timestep in one CUDA kernel, :mod:`repro_torch.kernels.fused_step`),
  ``"lif"`` (index_add segment-sum + the CUDA LIF kernel),
  ``"reference"`` (plain torch). ``None`` resolves to ``"fused"``; it
  does not apply to the other engines;
* ``device`` — where the engine runs. ``None`` resolves to the card;
  without one, resolving raises and names ``device="cpu"``. It takes
  the place of the reference's ``interpret`` knob: on the CPU the
  kernels' plain versions run, on CUDA the kernels.

* ``mesh`` — ``None`` runs on one device; ``"auto"`` (every visible
  CUDA device; without one, ``("cpu",)``) or a tuple of device strings
  data-shards the batch through the owned
  :class:`~repro_torch.serve.sharded.ShardedRunner` (``"torch"``
  engine only). A device may repeat: ``("cpu",) * 4`` is four shards
  run one after another, ``("cuda:0", "cuda:0")`` two on one card.
  With a mesh, ``device`` is left ``None`` (it resolves to the mesh's
  first device, the runner's single-device engine).

The reference's ``donate`` field is not ported: the port's engines own
their buffers (a captured shape replays over static ones), so there is
nothing for a caller to donate.
:meth:`ExecutionSpec.resolve` folds the defaults in once; the resolved
spec is the engine and runner cache key of ``Program.engine()`` and
``Program.sharded_runner()``. All engines and tiers are bit-exact.

The pre-spec kwargs (``engine=, nu_kernel=, interpret=, sharded=,
mesh=``) of ``Program.run``, ``Program.engine``,
``Program.sharded_runner``, ``Server``, ``ProgramRegistry.runner`` and
``ShardedRunner`` still work, with a ``DeprecationWarning``, through
:func:`spec_from_legacy_kwargs`.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

ENGINES = ("torch", "python", "oracle")
KERNELS = ("fused", "lif", "reference")
AUTO_MESH = "auto"
# reference engine names and where they stand in the port
_ENGINE_NOTES = {"jax": "the port's compiled engine is 'torch'"}
# the names a saved header, ``compile(engine=)`` and the legacy kwargs
# take for the port's engines
_ENGINE_ALIASES = {"jax": "torch"}


def default_kernel() -> str:
    """The ``"torch"`` engine's default kernel tier: ``"fused"``, the whole
    timestep in one launch, as in the reference."""
    return "fused"


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How to execute a compiled :class:`~repro_torch.core.program.Program`."""
    engine: str = "torch"
    kernel: str | None = None          # None -> "fused"
    device: str | None = None          # None -> the CUDA card
    mesh: object | None = None         # None | "auto" | tuple of devices

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, str):
            # a hashable tuple of device strings: the spec is a cache key
            object.__setattr__(self, "mesh",
                               tuple(str(d) for d in self.mesh))
        if self.engine not in ENGINES:
            note = _ENGINE_NOTES.get(self.engine)
            raise ValueError(f"unknown engine {self.engine!r}; use one of "
                             f"{ENGINES}" + (f" ({note})" if note else ""))
        if self.kernel is not None and self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; use one of "
                             f"{KERNELS} (or None for the default)")
        if self.engine != "torch" and self.kernel is not None:
            raise ValueError(f"kernel selects the torch engine's tier; it "
                             f"does not apply to engine={self.engine!r}")
        if self.mesh is not None:
            if self.engine != "torch":
                raise ValueError(f"mesh= shards the torch engine; got "
                                 f"engine={self.engine!r}")
            if isinstance(self.mesh, str) and self.mesh != AUTO_MESH:
                raise ValueError(f"mesh={self.mesh!r}: the only string form "
                                 f"is {AUTO_MESH!r} (every visible device)")
            if not self.mesh:
                raise ValueError("mesh=() names no device")
        if self.engine == "python" and (
                self.device is None or torch.device(self.device).type
                != "cpu"):
            raise ValueError(
                f"engine='python' is the host simulator and runs on the "
                f"CPU only; pass device=\"cpu\" (got device="
                f"{self.device!r})")

    @property
    def sharded(self) -> bool:
        """True iff this spec routes through the sharded runner."""
        return self.mesh is not None

    def single_device(self) -> "ExecutionSpec":
        """This spec without the mesh, on the mesh's first device — the
        per-device engine key the sharded runner (and its small-batch
        fallback) builds from. Call it on a resolved spec."""
        if self.mesh is None:
            return self
        return dataclasses.replace(self, mesh=None, device=self.mesh[0])

    def resolve(self) -> "ExecutionSpec":
        """Fold the defaults in: kernel ``"fused"`` (torch engine only),
        device the card, ``mesh="auto"`` every visible CUDA device (the
        CPU without one), each mesh device resolved like ``device``, and
        ``device`` the mesh's first.

        Raises ``RuntimeError`` when the spec names the card (or leaves
        the device to default) and no CUDA device is present, and
        ``ValueError`` for a mesh that mixes the card and the CPU or a
        ``device`` that is not the mesh's first. Idempotent.
        """
        kernel = self.kernel
        if self.engine == "torch" and kernel is None:
            kernel = default_kernel()
        if self.mesh is None:
            return dataclasses.replace(self, kernel=kernel,
                                       device=str(resolve_device(self.device)))
        mesh = self.mesh
        if mesh == AUTO_MESH:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            mesh = tuple(f"cuda:{i}" for i in range(n)) or ("cpu",)
        devices = tuple(resolve_device(d) for d in mesh)
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"mesh={self.mesh!r} mixes the card and the CPU; "
                             f"a mesh's devices are all CUDA or all 'cpu'")
        mesh = tuple(str(d) for d in devices)
        if self.device is not None and self.device != mesh[0]:
            raise ValueError(f"device={self.device!r} with mesh={mesh!r}: "
                             f"leave device to the mesh (its first device)")
        return dataclasses.replace(self, kernel=kernel, device=mesh[0],
                                   mesh=mesh)


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


# ---------------------------------------------------------------------------
# Legacy-kwarg shim: the deprecated Program.run(engine=, nu_kernel=,
# interpret=, sharded=, mesh=) surface delegates here.
# ---------------------------------------------------------------------------

_NU_KERNEL_TIER = {True: "lif", False: "reference"}


def spec_from_legacy_kwargs(*, engine=None, nu_kernel=None, interpret=None,
                            sharded=None, mesh=None, default_engine="torch",
                            where="Program.run", stacklevel=3
                            ) -> ExecutionSpec:
    """Map the pre-ExecutionSpec kwargs onto a spec, warning once; port of
    the reference's shim, with its semantics: ``nu_kernel=True`` is the
    ``"lif"`` tier, ``nu_kernel=False`` ``"reference"``; ``sharded=True``
    without a mesh is ``mesh="auto"``, and with an engine other than the
    compiled one an error; a mesh without ``sharded=True`` is ignored.

    The port's differences: ``engine="jax"`` is ``"torch"``;
    ``interpret=True`` (the kernels' plain semantics) runs on the CPU,
    ``device="cpu"`` (under ``sharded=True`` without a mesh, the mesh
    ``("cpu",)``), and ``interpret=False`` on the card; the ``"python"``
    engine, the host simulator, gets ``device="cpu"``.
    """
    passed = {k: v for k, v in [("engine", engine), ("nu_kernel", nu_kernel),
                                ("interpret", interpret),
                                ("sharded", sharded), ("mesh", mesh)]
              if v is not None}
    warnings.warn(
        f"{where}({', '.join(f'{k}=' for k in passed)}) is deprecated; "
        f"pass ExecutionSpec(engine=, kernel=, device=, mesh=) instead "
        f"(see README 'Migration to ExecutionSpec')",
        DeprecationWarning, stacklevel=stacklevel)
    engine = _ENGINE_ALIASES.get(engine, engine)
    device = "cpu" if interpret else None
    if sharded:
        engine = engine or "torch"
        if engine != "torch":
            raise ValueError(f"sharded=True runs the jax engine ('torch' "
                             f"in the port); got engine={engine!r}")
        if mesh is None:
            mesh = (device,) if device else AUTO_MESH
    else:
        mesh = None                     # old API: mesh ignored unless sharded
    engine = engine or default_engine
    if engine == "python":
        return ExecutionSpec(engine="python", device="cpu")
    if engine != "torch":
        return ExecutionSpec(engine=engine, device=device)
    kernel = None if nu_kernel is None else _NU_KERNEL_TIER[bool(nu_kernel)]
    if mesh is not None:
        return ExecutionSpec(kernel=kernel, mesh=mesh)
    return ExecutionSpec(kernel=kernel, device=device)
