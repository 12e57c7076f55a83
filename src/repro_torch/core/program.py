"""The compiled SupraSNN deployment artifact; port of the loading,
running, profiling and saving half of ``repro/core/program.py``.

A :class:`Program` is built from the arrays of a saved npz v1 artifact
(:meth:`Program.load`, or :meth:`Program.from_arrays` for the same
arrays held in memory) and owns its engines:

* ``program.run(ext, spec)`` — ``[T, n_inputs]`` / ``[B, T, n_inputs]``
  in, ``(spikes, v_final, stats)`` out, on the engine, device and kernel
  tier the :class:`~repro_torch.core.execution.ExecutionSpec` names (the
  ``"torch"`` engine on the card and the ``"fused"`` tier by default;
  ``"oracle"``, the dense integer LIF; ``"python"``, the host
  simulator, with ``device="cpu"``);
* ``program.profile(stats)`` — the ``CycleModel``'s latency and energy
  of the FPGA design and the resource report in one
  :class:`ProfileReport`;
* ``program.init_packets()`` — the MC-tree configuration stream;
* ``program.content_hash()`` — the artifact's identity, the reference's
  string;
* ``program.save(path)`` — the npz v1 artifact the reference writes, so
  either package loads the other's file;
* ``program.engine(spec)`` — the owned ``"torch"`` engine, built lazily
  and keyed on the resolved spec;
* ``program.sharded_runner(spec)`` — the owned data-parallel runner
  over the spec's mesh (:mod:`repro_torch.serve.sharded`), which
  ``program.run(ext, ExecutionSpec(mesh=...))`` goes through;
* ``program.precompile(buckets, T)`` — on the card, one CUDA graph of
  the T-step loop per bucket (on the fused tier one ``fused_run``
  launch where the plane fits a cluster's shared memory, else T
  ``fused_step`` launches; see
  :meth:`~repro_torch.core.engine_torch.TorchMappedEngine.precompile`).

* ``program.verify()`` — the static verifier's
  :class:`~repro_torch.analysis.diagnostics.VerifyReport`, no engine
  run;
* ``program.chip_span()``, ``mesh_hops()``, ``inter_chip_counts(ext,
  spikes)`` — the multi-chip accounting of the mapping, for
  ``profile(stats, inter_chip_counts=...)``.

:func:`compile` runs the pass pipeline of :mod:`repro_torch.core.passes`
(partition or portfolio search -> schedule -> validate -> lower ->
report) on the host, in numpy, and returns a :class:`Program` whose
arrays and header are the reference's compile of the same graph, bit
for bit but for wall times. A header whose ``default_engine`` is the
reference's ``"jax"`` maps to the port's ``"torch"``, and ``save``
writes it back as ``"jax"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core.aot import (content_hash, enable_persistent_cache,
                                  normalize_buckets)
from repro_torch.core.cost import ResourceReport
from repro_torch.core.engine import (CycleModel, CycleReport, PowerModel,
                                     oracle_packet_counts, packet_stats,
                                     run_mapped, run_oracle)
from repro_torch.core.engine_torch import (TorchMappedEngine,
                                           normalize_ext_spikes)
from repro_torch.core.execution import (_ENGINE_ALIASES, AUTO_MESH, ENGINES,
                                        ExecutionSpec, as_spec,
                                        spec_from_legacy_kwargs)
from repro_torch.core.graph import SNNGraph, from_quantized
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.search import SearchConfig, SearchTrace
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.passes import (CompileReport, build_report,
                                     initialization_packets, lower_pass,
                                     partition_pass, schedule_pass,
                                     search_pass, validate_pass)
from repro_torch.core.profiling import current_profiler, phase, profiled
from repro_torch.core.scheduling import LoweredProgram, OpTables, lower_tables
from repro_torch.snn.lif import LIFIntParams
from repro_torch.snn.quantize import QuantizedSNN

__all__ = ["PROGRAM_FORMAT", "PROGRAM_FORMAT_VERSION", "Program",
           "ProfileReport", "compile", "normalize_buckets"]

PROGRAM_FORMAT = "suprasnn-program"
PROGRAM_FORMAT_VERSION = 1
# the header's engine names: the reference's compiled engine is the port's
_ENGINE_HEADER = {"torch": "jax"}
# HardwareConfig fields added after format v1 shipped; written only at
# non-default values, as the reference writes them
_POST_V1_HW_FIELDS = frozenset({"n_chips", "inter_chip_hop_cycles",
                                "mesh_x", "mesh_y"})


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
class ProfileReport:
    """One-call profile of a run: timing/energy + hardware resources.

    ``per_sample`` holds one :class:`CycleReport` per batch sample;
    ``cycle`` aggregates them (mean over the batch; equal to
    ``per_sample[0]`` for unbatched runs). The scalar properties
    delegate to the aggregate. These are the cycle model's figures for
    the FPGA design, not times of the card.
    """
    cycle: CycleReport
    resources: ResourceReport
    per_sample: list[CycleReport]

    @property
    def latency_us(self) -> float:
        return self.cycle.latency_us

    @property
    def power_w(self) -> float:
        return self.cycle.power_w

    @property
    def energy_mj(self) -> float:
        return self.cycle.energy_mj

    @property
    def energy_per_synapse_nj(self) -> float:
        return self.cycle.energy_per_synapse_nj


def _aggregate_cycles(reports: list[CycleReport]) -> CycleReport:
    if len(reports) == 1:
        return reports[0]

    def mean(f):
        return float(np.mean([getattr(r, f) for r in reports]))

    return CycleReport(
        cycles_total=int(round(mean("cycles_total"))),
        cycles_distribution=int(round(mean("cycles_distribution"))),
        cycles_synaptic=int(round(mean("cycles_synaptic"))),
        cycles_overhead=int(round(mean("cycles_overhead"))),
        latency_us=mean("latency_us"), power_w=reports[0].power_w,
        energy_mj=mean("energy_mj"),
        energy_per_synapse_nj=mean("energy_per_synapse_nj"))


@dataclasses.dataclass
class Program:
    """A compiled, runnable, persistable SupraSNN deployment artifact."""
    graph: SNNGraph
    hw: HardwareConfig
    tables: OpTables
    lowered: LoweredProgram
    report: CompileReport
    part: PartitionResult
    default_engine: str = "torch"
    _engines: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    # -- summary properties -------------------------------------------------

    @property
    def feasible(self) -> bool:
        return self.report.feasible

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

    def engine(self, spec: ExecutionSpec | None = None, *,
               nu_kernel: bool | None = None,
               interpret: bool | None = None) -> TorchMappedEngine:
        """The owned ``"torch"`` engine for ``spec``, keyed on the
        resolved spec so an explicit value and the default it resolves
        to share one. ``nu_kernel=``/``interpret=`` are the deprecated
        pre-spec kwargs."""
        if nu_kernel is not None or interpret is not None:
            if spec is not None:
                raise TypeError("pass spec= OR the deprecated nu_kernel=/"
                                "interpret= kwargs, not both")
            spec = spec_from_legacy_kwargs(
                nu_kernel=nu_kernel, interpret=interpret,
                where="Program.engine", stacklevel=3)
        spec = as_spec(spec, self.default_engine).resolve().single_device()
        if spec.engine != "torch":
            raise ValueError(f"Program.engine builds the torch engine; got "
                             f"engine={spec.engine!r}")
        eng = self._engines.get(spec)
        if eng is None:
            eng = TorchMappedEngine(self.graph, self.lowered, spec)
            self._engines[spec] = eng
        return eng

    def sharded_runner(self, spec=None, *, nu_kernel: bool | None = None,
                       interpret: bool | None = None):
        """The owned multi-device runner for ``spec``.

        ``spec`` may be an :class:`ExecutionSpec` (``mesh=None`` means
        ``"auto"`` here), a bare mesh (``"auto"`` or a tuple of device
        strings), or ``None`` (``"auto"``). See
        :mod:`repro_torch.serve.sharded`. Runners are cached like
        engines: same resolved spec -> same object.
        ``nu_kernel=``/``interpret=`` are the deprecated pre-spec kwargs.
        """
        from repro_torch.serve.sharded import ShardedRunner
        mesh = None
        if spec is not None and not isinstance(spec, ExecutionSpec):
            mesh, spec = spec, None         # bare-mesh convenience form
        if nu_kernel is not None or interpret is not None:
            if spec is not None:
                raise TypeError("pass spec= OR the deprecated nu_kernel=/"
                                "interpret= kwargs, not both")
            spec = spec_from_legacy_kwargs(
                sharded=True, mesh=mesh, nu_kernel=nu_kernel,
                interpret=interpret, where="Program.sharded_runner",
                stacklevel=3)
        elif spec is None:
            spec = ExecutionSpec(mesh=AUTO_MESH if mesh is None else mesh)
        if spec.mesh is None:
            spec = dataclasses.replace(spec, mesh=AUTO_MESH)
        spec = spec.resolve()
        runner = self._engines.get(spec)
        if runner is None:
            runner = ShardedRunner(self, spec=spec)
            self._engines[spec] = runner
        return runner

    def precompile(self, batch_sizes, timesteps: int,
                   spec: ExecutionSpec | None = None) -> list:
        """Prepare the engine for every serving shape NOW.

        ``batch_sizes`` is a :class:`~repro_torch.serve.batcher
        .BatchPolicy` or an iterable of batch sizes; ``timesteps`` fixes
        the T axis. On the card the ``"fused"`` and ``"lif"`` tiers
        capture one CUDA graph of the T-step loop per shape (the fused
        tier's run path: one ``fused_run`` launch); elsewhere
        each shape is run once on zeros. A ``mesh`` spec prepares the
        owned sharded runner's shapes. Returns the shapes prepared by
        this call; idempotent per engine. Also resolves the directory
        the kernels' library is built into and loaded from
        (:func:`~repro_torch.core.aot.enable_persistent_cache`).
        """
        enable_persistent_cache()
        spec = as_spec(spec, self.default_engine)
        target = (self.sharded_runner(spec) if spec.sharded
                  else self.engine(spec))
        return target.precompile(normalize_buckets(batch_sizes), timesteps)

    def content_hash(self) -> str:
        """SHA-256 over the lowered program + LIF params — the stable
        identity of the compiled computation (:mod:`repro_torch.core.aot`)."""
        return content_hash(self)

    # -- execution ----------------------------------------------------------

    def run(self, ext_spikes: np.ndarray,
            spec: "ExecutionSpec | str | None" = None, *,
            engine: str | None = None, nu_kernel: bool | None = None,
            interpret: bool | None = None, sharded: bool | None = None,
            mesh=None) -> tuple[np.ndarray, np.ndarray, dict]:
        """Execute the program on a spike train (batch).

        ext_spikes: binary ``[T, n_inputs]`` or ``[B, T, n_inputs]``.
        spec: an :class:`~repro_torch.core.execution.ExecutionSpec`, an
        engine-name string (``"torch"``, ``"oracle"``; ``"python"`` needs
        ``device="cpu"`` in a spec), or ``None`` for
        ``self.default_engine``. Every engine and tier returns
        ``(spikes, v_final, stats)`` — ``[T, n_internal]`` /
        ``[n_internal]`` / packet_counts ``[T]``, batched with a leading
        ``B`` — with the reference's bits and dtypes.
        ``ExecutionSpec(mesh=...)`` data-parallelizes the batch axis over
        the mesh's devices through the owned
        :class:`~repro_torch.serve.sharded.ShardedRunner`.

        ``engine=/nu_kernel=/interpret=/sharded=/mesh=`` are the
        deprecated pre-spec kwargs and delegate with a
        ``DeprecationWarning`` (:func:`~repro_torch.core.execution
        .spec_from_legacy_kwargs`).
        """
        if (engine is not None or nu_kernel is not None
                or interpret is not None or sharded is not None
                or mesh is not None):
            if spec is not None:
                raise TypeError("pass spec OR the deprecated engine=/"
                                "nu_kernel=/interpret=/sharded=/mesh= "
                                "kwargs, not both")
            spec = spec_from_legacy_kwargs(
                engine=engine, nu_kernel=nu_kernel, interpret=interpret,
                sharded=sharded, mesh=mesh,
                default_engine=self.default_engine)
        spec = as_spec(spec, self.default_engine)
        if spec.sharded:
            return self.sharded_runner(spec).run(ext_spikes)
        if spec.engine == "torch":
            return self.engine(spec).run(ext_spikes)
        device = spec.resolve().device
        ext, squeeze = normalize_ext_spikes(ext_spikes, self.graph.n_inputs)
        ext = ext.astype(np.int32)
        if spec.engine == "python":
            runs = [run_mapped(self.graph, self.tables, e,
                               routing=self.lowered.routing) for e in ext]
            s_all = np.stack([r[0] for r in runs])
            v_all = np.stack([r[1] for r in runs])
            p_all = np.stack([r[2]["packet_counts"] for r in runs])
        else:
            s_all, v_all = run_oracle(self.graph, ext, device)
            p_all = oracle_packet_counts(ext, s_all)
        if squeeze:
            s_all, v_all, p_all = s_all[0], v_all[0], p_all[0]
        return s_all, v_all, packet_stats(p_all)

    # -- profiling ----------------------------------------------------------

    def profile(self, stats: dict | np.ndarray, *,
                n_synapses: int | None = None,
                power: PowerModel | None = None,
                inter_chip_counts: np.ndarray | None = None
                ) -> ProfileReport:
        """CycleModel timing/energy + resource report in one call.

        ``stats`` is the dict returned by :meth:`run` (or a raw
        packet-counts array, ``[T]`` or ``[B, T]``). ``n_synapses``
        overrides the energy-per-synapse denominator (e.g. the
        pre-pruning synapse count of a quantized model); defaults to
        the mapped graph's nonzero synapses. ``inter_chip_counts`` (same
        shape as the packet counts) charges forwarded packets their hop
        cost — omitted, the profile is the single-chip model.
        """
        pkts = stats["packet_counts"] if isinstance(stats, dict) else stats
        pkts = np.atleast_2d(np.asarray(pkts))
        if inter_chip_counts is None:
            ics = [None] * pkts.shape[0]
        else:
            ic = np.atleast_2d(np.asarray(inter_chip_counts))
            if ic.shape != pkts.shape:
                raise ValueError(f"inter_chip_counts shape {ic.shape} != "
                                 f"packet_counts shape {pkts.shape}")
            ics = list(ic)
        n_syn = self.graph.n_synapses if n_synapses is None else n_synapses
        cm = CycleModel(self.hw, power)
        per = [cm.run(row, self.tables.depth, n_syn, inter_chip_counts=i)
               for row, i in zip(pkts, ics)]
        return ProfileReport(cycle=_aggregate_cycles(per),
                             resources=self.report.resources,
                             per_sample=per)

    # -- multi-chip accounting ------------------------------------------------

    def chip_span(self) -> np.ndarray:
        """[n_neurons] distinct chips each neuron's fan-out spans under
        this program's mapping (all-ones/zeros on a single-chip hw)."""
        from repro_torch.core.mapping.hypergraph import chip_span
        return chip_span(self.graph, self.tables.assign, self.hw)

    def mesh_hops(self) -> np.ndarray:
        """[n_neurons] 2D-mesh hop cost of each neuron's multicast under
        this program's mapping (all zeros on a single-chip hw)."""
        from repro_torch.core.mapping.hypergraph import mesh_hops
        return mesh_hops(self.graph, self.tables.assign, self.hw)

    def inter_chip_counts(self, ext_spikes: np.ndarray,
                          spikes: np.ndarray) -> np.ndarray:
        """Per-timestep inter-chip mesh hops of a run, for
        :meth:`profile`'s ``inter_chip_counts=``: each firing neuron
        charges the XY-mesh bounding-box hop count of its multicast
        (:meth:`mesh_hops`). ``ext_spikes`` and ``spikes`` are the run's
        input and output spike trains (``[T, n]`` or ``[B, T, n]``). All
        zeros when ``n_chips == 1``.
        """
        from repro_torch.core.mapping.hypergraph import inter_chip_hop_counts
        return inter_chip_hop_counts(ext_spikes, spikes, self.mesh_hops())

    # -- static verification --------------------------------------------------

    def verify(self, checkers: "list[str] | None" = None):
        """Statically verify the artifact without executing any engine.

        Runs the registered checkers of :mod:`repro_torch.analysis`
        (schedule hazards, integer ranges, the Eq. 9/11 memory audit)
        and returns their
        :class:`~repro_torch.analysis.diagnostics.VerifyReport`
        (``report.ok`` iff no ERROR diagnostic). The CLI form is
        ``python -m repro_torch.analysis.verify artifact.npz``.
        """
        # from the verify module itself: once ``repro_torch.analysis.verify``
        # is imported as a module, the package attribute of that name is
        # the module, not the function
        from repro_torch.analysis.verify import verify as _verify
        return _verify(self, checkers=checkers)

    # -- initialization stream ----------------------------------------------

    def init_packets(self) -> list[tuple[int, int]]:
        """The MC-tree (ctrl, payload) configuration stream (§4.3)."""
        return initialization_packets(self.graph, self.tables, self.hw,
                                      routing=self.lowered.routing)

    # -- persistence --------------------------------------------------------

    def save(self, path: str | Path) -> Path:
        """Persist the artifact as the reference's npz v1 (JSON header +
        dense arrays); returns the file path (``.npz`` appended if
        missing). Post-v1 ``HardwareConfig`` fields are written only at
        non-default values, the ``phase_*`` report keys only when
        present, and the ``"torch"`` engine as ``"jax"``, so the
        reference loads the file.
        """
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_name(path.name + ".npz")
        g, hw, rep, part = self.graph, self.hw, self.report, self.part
        res = rep.resources
        header = {
            "format": PROGRAM_FORMAT,
            "version": PROGRAM_FORMAT_VERSION,
            "default_engine": _ENGINE_HEADER.get(self.default_engine,
                                                 self.default_engine),
            "graph": {
                "n_inputs": int(g.n_inputs),
                "n_neurons": int(g.n_neurons),
                "output_slice": [int(g.output_slice[0]),
                                 int(g.output_slice[1])],
                "lif": {"leak_shift": int(g.lif.leak_shift),
                        "v_threshold": int(g.lif.v_threshold),
                        "v_reset": int(g.lif.v_reset)},
            },
            "hw": {f.name: getattr(hw, f.name)
                   for f in dataclasses.fields(hw)
                   if f.name not in _POST_V1_HW_FIELDS
                   or getattr(hw, f.name) != f.default},
            "report": {
                "method": rep.method,
                "feasible": bool(rep.feasible),
                "iterations": int(rep.iterations),
                "perturbations": int(rep.perturbations),
                "ot_depth": int(rep.ot_depth),
                "n_init_packets": int(rep.n_init_packets),
                "compile_seconds": float(rep.compile_seconds),
                "resources": {"luts": int(res.luts), "ffs": int(res.ffs),
                              "brams": float(res.brams),
                              "memory_kb": float(res.memory_kb)},
                "search": rep.search.to_json() if rep.search else None,
                "candidates_tried": int(rep.candidates_tried),
                "schedule_method": rep.schedule_method,
                "schedule_depths": ({k: int(v) for k, v
                                     in rep.schedule_depths.items()}
                                    if rep.schedule_depths else None),
                **({"phase_seconds": {k: float(v) for k, v
                                      in rep.phase_seconds.items()}}
                   if rep.phase_seconds else {}),
                **({"phase_alloc_mb": {k: float(v) for k, v
                                       in rep.phase_alloc_mb.items()}}
                   if rep.phase_alloc_mb else {}),
            },
            "part": {
                "feasible": bool(part.feasible),
                "iterations": int(part.iterations),
                "perturbations": int(part.perturbations),
            },
        }
        np.savez_compressed(
            path,
            header=np.asarray(json.dumps(header)),
            g_pre=g.pre, g_post=g.post, g_weight=g.weight,
            t_pre=self.tables.pre, t_post=self.tables.post,
            t_weight=self.tables.weight, t_pre_end=self.tables.pre_end,
            t_post_end=self.tables.post_end, t_assign=self.tables.assign,
            part_assign=part.assign, part_scores=part.scores,
            part_history=np.asarray(part.score_history, np.float64),
            rep_scores=rep.scores,
            rep_spu_synapse_counts=rep.spu_synapse_counts,
            rep_spu_post_counts=rep.spu_post_counts,
            rep_spu_weight_counts=rep.spu_weight_counts)
        return path

    @classmethod
    def from_arrays(cls, header: dict, arrays: dict, *,
                    source="arrays") -> "Program":
        """Build a Program from an artifact's parsed JSON header and its
        numpy arrays, the ones ``save`` writes. ``source`` names them in
        error messages."""
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
        ph = header["part"]
        part = PartitionResult(
            assign=arrays["part_assign"], scores=arrays["part_scores"],
            feasible=ph["feasible"], iterations=ph["iterations"],
            perturbations=ph["perturbations"],
            score_history=arrays["part_history"].tolist())
        rh = header["report"]
        report = CompileReport(
            method=rh["method"], feasible=rh["feasible"],
            iterations=rh["iterations"], perturbations=rh["perturbations"],
            ot_depth=rh["ot_depth"], scores=arrays["rep_scores"],
            spu_synapse_counts=arrays["rep_spu_synapse_counts"],
            spu_post_counts=arrays["rep_spu_post_counts"],
            spu_weight_counts=arrays["rep_spu_weight_counts"],
            resources=ResourceReport(**rh["resources"]),
            n_init_packets=rh["n_init_packets"],
            compile_seconds=rh["compile_seconds"],
            search=(SearchTrace.from_json(rh["search"])
                    if rh.get("search") else None),
            candidates_tried=rh.get("candidates_tried", 1),
            schedule_method=rh.get("schedule_method", "slack"),
            schedule_depths=rh.get("schedule_depths"),
            phase_seconds=rh.get("phase_seconds"),
            phase_alloc_mb=rh.get("phase_alloc_mb"))
        # re-lower (pure, deterministic) — never re-partition
        lowered = lower_tables(g, tables)
        engine = header.get("default_engine", "jax")
        return cls(g, hw, tables, lowered, report, part,
                   default_engine=_ENGINE_ALIASES.get(engine, engine))

    @classmethod
    def load(cls, path: str | Path, *, precompile=None,
             timesteps: int | None = None,
             spec: ExecutionSpec | None = None) -> "Program":
        """Load a saved artifact; rejects unknown formats/versions.

        ``precompile=`` (a ``BatchPolicy`` or iterable of batch buckets,
        with ``timesteps=`` fixing the T axis) prepares the engine for
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


# ---------------------------------------------------------------------------
# The compile entry point.
# ---------------------------------------------------------------------------

def compile(g_or_qsnn: SNNGraph | QuantizedSNN, hw: HardwareConfig, *,
            method: str = "framework", engine: str = "torch", seed: int = 0,
            validate: bool = True, max_iters: int = 20000,
            restarts: int = 1, workers: int = 1,
            schedule_method: str = "slack",
            search: SearchConfig | None = None,
            n_chips: int | None = None,
            profile_phases: bool = True) -> Program:
    """Compile an SNN (graph or the port's quantized model) into a
    :class:`Program`; port of ``repro.core.program.compile``.

    Runs partition -> schedule -> [validate] -> lower -> report (see
    :mod:`repro_torch.core.passes`) on the host and wraps every product
    in the artifact. ``engine`` picks the default executor of
    :meth:`Program.run`: ``"torch"`` (the card's kernels; the
    reference's ``"jax"`` is taken as its alias), ``"python"`` or
    ``"oracle"``. ``method``/``seed``/``max_iters``/``restarts``/
    ``workers`` parameterize the partitioning pass, and
    ``schedule_method`` names the registered
    :class:`~repro_torch.core.scheduling.ScheduleStrategy`.

    ``n_chips=N`` replicates the single-chip ``hw`` N times over the
    flattened virtual tree (``n_spus`` becomes ``hw.n_spus * N``); the
    memory and cycle models pick up the per-chip structures and the
    inter-chip hop costs.

    ``search=SearchConfig(...)`` replaces the partition pass with the
    joint portfolio search (framework restarts raced against every
    baseline and the extra strategies, each feasible mapping scheduled
    under every registered schedule strategy); the trace lands on
    ``program.report.search`` and the winning strategy on
    ``program.report.schedule_method``.

    ``profile_phases=True`` records the per-phase wall time on
    ``report.phase_seconds``; wrap the call in
    ``profiled(PhaseProfiler(alloc=True))`` to also record per-phase
    allocation on ``report.phase_alloc_mb``.
    """
    engine = _ENGINE_ALIASES.get(engine, engine)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    t0 = time.time()
    if n_chips is not None and n_chips != 1:
        if hw.n_chips != 1:
            raise ValueError(
                f"compile(n_chips={n_chips}) replicates a SINGLE-chip "
                f"HardwareConfig; hw already has n_chips={hw.n_chips}")
        hw = dataclasses.replace(hw, n_spus=hw.n_spus * n_chips,
                                 n_chips=n_chips)
    g = (from_quantized(g_or_qsnn) if isinstance(g_or_qsnn, QuantizedSNN)
         else g_or_qsnn)
    trace = None
    tables = None
    schedule_depths = None
    # reuse a caller-installed profiler so nested compiles accumulate
    # into it; otherwise install a wall-clock-only one unless disabled
    prof = current_profiler()
    ctx = (contextlib.nullcontext(prof)
           if (prof is not None or not profile_phases) else profiled())
    with ctx as prof:
        if search is not None:
            if (method, seed, max_iters, restarts, workers,
                    schedule_method) != \
                    ("framework", 0, 20000, 1, 1, "slack"):
                raise ValueError(
                    "search= runs the joint portfolio and takes its "
                    "parameters from the SearchConfig; pass "
                    "seed/max_iters/restarts/workers there instead of as "
                    "compile() arguments (the portfolio explores every "
                    "registered schedule strategy, so schedule_method= "
                    "does not apply)")
            with phase("partition"):
                part, trace, tables = search_pass(g, hw, search)
            method = "portfolio"
            if tables is not None:
                sel = trace.selected
                schedule_method = sel.schedule_method or "slack"
                schedule_depths = sel.schedule_depths
            else:
                schedule_method = "slack"  # infeasible winner: default
        else:
            with phase("partition"):
                part = partition_pass(g, hw, method=method, seed=seed,
                                      max_iters=max_iters,
                                      restarts=restarts, workers=workers)
        if tables is None:
            with phase("schedule"):
                tables = schedule_pass(g, part, hw, method=schedule_method)
        if validate:
            with phase("validate"):
                validate_pass(g, tables)
        with phase("lower"):
            lowered = lower_pass(g, tables)
        with phase("report"):
            report = build_report(g, hw, tables, part, method=method,
                                  compile_seconds=time.time() - t0,
                                  routing=lowered.routing, search=trace,
                                  schedule_method=schedule_method,
                                  schedule_depths=schedule_depths)
    if prof is not None:
        report.phase_seconds = {k: float(v) for k, v in prof.seconds.items()}
        if prof.alloc:
            report.phase_alloc_mb = {k: float(v)
                                     for k, v in prof.alloc_mb.items()}
    return Program(g, hw, tables, lowered, report, part,
                   default_engine=engine)
