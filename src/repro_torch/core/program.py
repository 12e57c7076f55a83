"""The compiled SupraSNN deployment artifact; port of the loading and
running half of ``repro/core/program.py``.

A :class:`Program` is built from the arrays of a saved npz v1 artifact
(:meth:`Program.load`, or :meth:`Program.from_arrays` for the same
arrays held in memory) and owns its engines:

* ``program.run(ext, spec)`` — ``[T, n_inputs]`` / ``[B, T, n_inputs]``
  in, ``(spikes, v_final, stats)`` out, on the device and kernel tier
  the :class:`~repro_torch.core.execution.ExecutionSpec` names (the
  card and the ``"fused"`` tier by default);
* ``program.engine(spec)`` — the owned engine, built lazily and keyed
  on the resolved spec;
* ``program.precompile(buckets, T)`` — warms every serving shape.

The compiler (``compile``), ``CompileReport``/``PartitionResult``,
``profile``, ``init_packets``, ``verify`` and ``save`` wait for later
slices. Until then the header's ``report`` and ``part`` dicts and their
arrays are kept as they were read, so a later ``save`` can write them
back unchanged. A header whose ``default_engine`` is the reference's
``"jax"`` maps to the port's ``"torch"``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.core.engine_torch import TorchMappedEngine
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling import LoweredProgram, OpTables, lower_tables
from repro_torch.snn.lif import LIFIntParams

PROGRAM_FORMAT = "suprasnn-program"
PROGRAM_FORMAT_VERSION = 1
_ENGINE_ALIASES = {"jax": "torch"}
# arrays of the report and partition, kept as read
_META_ARRAYS = ("part_assign", "part_scores", "part_history", "rep_scores",
                "rep_spu_synapse_counts", "rep_spu_post_counts",
                "rep_spu_weight_counts")


def normalize_buckets(buckets) -> tuple[int, ...]:
    """Coerce a ``BatchPolicy`` or iterable of batch sizes to sorted
    unique positive ints — the shapes precompile walks (port of
    ``repro/core/aot.py::normalize_buckets``)."""
    buckets = getattr(buckets, "buckets", buckets)
    if isinstance(buckets, (int, np.integer)):
        buckets = (buckets,)
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"precompile buckets must be positive batch "
                         f"sizes, got {buckets}")
    return out


def _check_header(header: dict, where) -> None:
    if header.get("format") != PROGRAM_FORMAT:
        raise ValueError(
            f"{where}: format {header.get('format')!r} != "
            f"{PROGRAM_FORMAT!r}")
    if header.get("version") != PROGRAM_FORMAT_VERSION:
        raise ValueError(
            f"{where}: format version {header.get('version')} "
            f"unsupported (have {PROGRAM_FORMAT_VERSION})")


@dataclasses.dataclass
class Program:
    """A compiled, runnable SupraSNN deployment artifact."""
    graph: SNNGraph
    hw: HardwareConfig
    tables: OpTables
    lowered: LoweredProgram
    report: dict                       # header "report", as read
    part: dict                         # header "part", as read
    meta_arrays: dict                  # report/partition arrays, as read
    default_engine: str = "torch"
    _engines: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    # -- summary properties -------------------------------------------------

    @property
    def feasible(self) -> bool:
        return bool(self.report["feasible"])

    @property
    def ot_depth(self) -> int:
        return self.tables.depth

    @property
    def n_inputs(self) -> int:
        return self.graph.n_inputs

    @property
    def n_synapses(self) -> int:
        return self.graph.n_synapses

    # -- engines ------------------------------------------------------------

    def engine(self, spec: ExecutionSpec | None = None) -> TorchMappedEngine:
        """The owned engine for ``spec``, keyed on the resolved spec so
        an explicit value and the default it resolves to share one."""
        spec = as_spec(spec, self.default_engine).resolve()
        eng = self._engines.get(spec)
        if eng is None:
            eng = TorchMappedEngine(self.graph, self.lowered, spec)
            self._engines[spec] = eng
        return eng

    def precompile(self, batch_sizes, timesteps: int,
                   spec: ExecutionSpec | None = None) -> list:
        """Warm the engine for every serving shape NOW.

        ``batch_sizes`` is a :class:`~repro_torch.serve.batcher
        .BatchPolicy` or an iterable of batch sizes; ``timesteps`` fixes
        the T axis. Returns the shapes warmed by this call; idempotent
        per engine.
        """
        return self.engine(spec).precompile(normalize_buckets(batch_sizes),
                                            timesteps)

    def run(self, ext_spikes: np.ndarray,
            spec: "ExecutionSpec | str | None" = None
            ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Execute the program on a spike train (batch).

        ext_spikes: binary ``[T, n_inputs]`` or ``[B, T, n_inputs]``.
        Returns ``(spikes, v_final, stats)`` — ``[T, n_internal]`` /
        ``[n_internal]`` / packet_counts ``[T]``, batched with a leading
        ``B`` — with the reference's bits on every tier and device.
        """
        return self.engine(spec).run(ext_spikes)

    # -- persistence --------------------------------------------------------

    @classmethod
    def from_arrays(cls, header: dict, arrays: dict, *,
                    source="arrays") -> "Program":
        """Build a Program from an artifact's parsed JSON header and its
        numpy arrays, the ones ``repro.Program.save`` writes. ``source``
        names them in error messages."""
        _check_header(header, source)
        gh = header["graph"]
        g = SNNGraph(
            n_inputs=gh["n_inputs"], n_neurons=gh["n_neurons"],
            pre=arrays["g_pre"], post=arrays["g_post"],
            weight=arrays["g_weight"],
            lif=LIFIntParams(**gh["lif"]),
            output_slice=tuple(gh["output_slice"]))
        hw = HardwareConfig(**header["hw"])
        tables = OpTables.from_dense(
            arrays["t_pre"], arrays["t_post"], arrays["t_weight"],
            arrays["t_pre_end"], arrays["t_post_end"], arrays["t_assign"])
        # re-lower (pure, deterministic) — never re-partition
        lowered = lower_tables(g, tables)
        engine = header.get("default_engine", "jax")
        return cls(g, hw, tables, lowered, header["report"], header["part"],
                   {k: arrays[k] for k in _META_ARRAYS},
                   default_engine=_ENGINE_ALIASES.get(engine, engine))

    @classmethod
    def load(cls, path: str | Path, *, precompile=None,
             timesteps: int | None = None,
             spec: ExecutionSpec | None = None) -> "Program":
        """Load a saved artifact; rejects unknown formats/versions.

        ``precompile=`` (a ``BatchPolicy`` or iterable of batch buckets,
        with ``timesteps=`` fixing the T axis) warms the engine for
        every serving shape at load time — see :meth:`precompile`.
        """
        with np.load(path) as z:
            if "header" not in z.files:
                raise ValueError(f"{path}: not a {PROGRAM_FORMAT} artifact")
            header = json.loads(str(z["header"][()]))
            arrays = {k: z[k] for k in z.files if k != "header"}
        prog = cls.from_arrays(header, arrays, source=path)
        if precompile is not None:
            if timesteps is None:
                raise ValueError("Program.load(precompile=...) needs "
                                 "timesteps= to fix the T axis of the "
                                 "warmed shapes")
            prog.precompile(precompile, timesteps, spec)
        return prog
