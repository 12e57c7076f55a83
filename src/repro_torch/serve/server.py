"""Server loop: drive request streams against a ``ProgramRegistry``.

Port of ``repro/serve/server.py`` over the port's registry and
batcher, with the reference's deprecated ``sharded=``/``mesh=`` kwargs
(:func:`~repro_torch.core.execution.spec_from_legacy_kwargs`).

No HTTP — a :class:`Request` stream is a list of (model, spike train,
arrival time, stream id) records, which is what a transport layer
would produce anyway. The server groups the stream per model (each
model owns one micro-batch queue), drains every queue under its
:class:`~repro_torch.serve.batcher.BatchPolicy`, and surfaces p50/p99/
throughput/shed/stage metrics as a plain dict.

**Timelines.** Multi-model totals are only meaningful on an explicit
execution timeline, so the server owns one:

* ``timeline="shared"`` (default): ONE serially-busy engine is shared
  by every model — dispatches interleave in global time order (ties
  broken by model-name order), so a batch for model A delays model B
  exactly as it would on one accelerator. Totals are computed on that
  single clock.
* ``timeline="per-engine"``: every model simulates on its own
  engine clock from 0, as if each had a dedicated accelerator; totals
  then read as the union wall-span of genuinely concurrent engines.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.execution import spec_from_legacy_kwargs
from repro_torch.serve.batcher import (BatchPolicy, DrainResult,
                                       MicroBatcher, SHED_REASONS,
                                       drain_together, latency_metrics)
from repro_torch.serve.registry import ProgramRegistry

_TIMELINES = ("shared", "per-engine")


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request: a spike train for a named model."""
    model: str
    ext: np.ndarray                  # binary [T, n_inputs]
    arrival_us: float
    stream: int = 0                  # client-stream tag (FIFO per stream)


def _aggregate_totals(results: dict[str, DrainResult],
                      timeline: str) -> dict:
    """Totals over every model's served requests on one declared
    timeline, plus shed / deadline / stage accounting."""
    lats = [r.latencies_us[r.served] for r in results.values()]
    comps = [r.completion_us[r.served] for r in results.values()]
    lat = np.concatenate(lats) if lats else np.zeros(0)
    comp = np.concatenate(comps) if comps else np.zeros(0)
    total = latency_metrics(lat, comp)
    total["models"] = len(results)
    total["timeline"] = timeline
    shed = {name: 0 for name in SHED_REASONS.values()}
    n_req = 0
    stage_arrays: dict[str, list[np.ndarray]] = {
        "queue_wait": [], "batch_fill": [], "pad": [], "compute": []}
    for r in results.values():
        n_req += r.n_requests
        for k, v in r.shed_counts().items():
            shed[k] += v
        stage_arrays["queue_wait"].append(r.queue_wait_us[r.served])
        stage_arrays["batch_fill"].append(r.fill_wait_us[r.served])
        stage_arrays["pad"].append(r.pad_us[r.served])
        stage_arrays["compute"].append(r.compute_us[r.served])
    total["shed"] = shed
    n_shed = sum(shed.values())
    total["shed_frac"] = n_shed / n_req if n_req else 0.0
    total["deadline_misses"] = shed["deadline"]
    total["stages_us"] = {
        k: (float(np.concatenate(v).mean()) if len(lat) else 0.0)
        for k, v in stage_arrays.items()}
    return total


class Server:
    """Drains request streams against the registry, one queue per model.

    policy: default :class:`BatchPolicy`. Per-model overrides resolve
    ``policies[name]`` first, then the policy registered with the
    model (``ProgramRegistry.register(policy=...)``), then ``policy``.
    ``service_model`` (bucket -> us) makes latencies deterministic;
    ``None`` measures real engine calls. ``spec`` (an
    :class:`~repro_torch.core.execution.ExecutionSpec`) routes every
    model through that execution point (device, kernel tier).
    ``timeline`` picks the multi-model accounting clock (see module
    docstring). ``sharded=``/``mesh=`` are the deprecated pre-spec
    kwargs.
    """

    def __init__(self, registry: ProgramRegistry, *,
                 policy: BatchPolicy | None = None,
                 policies: dict[str, BatchPolicy] | None = None,
                 service_model=None, spec=None, timeline: str = "shared",
                 sharded: bool | None = None, mesh=None):
        if sharded is not None or mesh is not None:
            if spec is not None:
                raise TypeError("pass spec= OR the deprecated sharded=/"
                                "mesh= kwargs, not both")
            spec = spec_from_legacy_kwargs(sharded=sharded, mesh=mesh,
                                           where="Server", stacklevel=3)
        if timeline not in _TIMELINES:
            raise ValueError(f"timeline must be one of {_TIMELINES}, "
                             f"got {timeline!r}")
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.policies = dict(policies or {})
        self.service_model = service_model
        self.spec = spec
        self.timeline = timeline
        self.last_results: dict[str, DrainResult] = {}
        # MicroBatchers are reused across serve() calls so the warmed
        # (bucket, T, dtype) cache survives — keyed on the program
        # identity so replacing a model rebuilds its batcher
        self._batchers: dict[str, tuple[int, MicroBatcher]] = {}

    def policy_for(self, name: str) -> BatchPolicy:
        """Per-call override > registry-registered policy > default."""
        if name in self.policies:
            return self.policies[name]
        registered = self.registry.policy(name)
        return registered if registered is not None else self.policy

    def _batcher(self, name: str) -> MicroBatcher:
        program = self.registry.get(name)
        cached = self._batchers.get(name)
        if cached is not None and cached[0] == id(program):
            return cached[1]
        batcher = MicroBatcher(self.policy_for(name),
                               runner=self.registry.runner(name, self.spec),
                               service_model=self.service_model)
        self._batchers[name] = (id(program), batcher)
        return batcher

    @staticmethod
    def _validate_shapes(name: str,
                         pairs: list[tuple[int, Request]]) -> tuple:
        """All requests for one model must agree on [T, n_inputs];
        name the offending request index and stream otherwise."""
        k0, r0 = pairs[0]
        ref = np.asarray(r0.ext).shape
        if len(ref) != 2:
            raise ValueError(
                f"request #{k0} for model {name!r} (stream {r0.stream}) "
                f"has spike-train shape {ref}; expected a 2-D "
                f"[T, n_inputs] array")
        for k, r in pairs[1:]:
            shape = np.asarray(r.ext).shape
            if shape != ref:
                raise ValueError(
                    f"request #{k} for model {name!r} (stream {r.stream}) "
                    f"has spike-train shape {shape}, but request #{k0} "
                    f"(stream {r0.stream}) set [T, n_inputs] = {ref}; all "
                    f"requests for one model must agree")
        return ref

    def serve(self, stream: list[Request]) -> dict:
        """Serve every request; return the metrics dict.

        The stream may interleave models and client streams; within
        each model requests are served FIFO by arrival time (ties keep
        stream order — the sort is stable).
        """
        order = sorted(range(len(stream)),
                       key=lambda k: stream[k].arrival_us)
        by_model: dict[str, list[tuple[int, Request]]] = {}
        for k in order:
            r = stream[k]
            if r.model not in self.registry:
                raise KeyError(f"request for unregistered model "
                               f"{r.model!r}; have {self.registry.names()}")
            by_model.setdefault(r.model, []).append((k, r))

        names = sorted(by_model)           # queue order = tie-break order
        items = []
        for name in names:
            pairs = by_model[name]
            self._validate_shapes(name, pairs)
            ext = np.stack([np.asarray(r.ext) for _, r in pairs])
            arrivals = np.asarray([r.arrival_us for _, r in pairs])
            items.append((self._batcher(name), arrivals, ext))

        if self.timeline == "shared":
            drained = drain_together(items)
        else:
            drained = [b.drain(arr, ext) for b, arr, ext in items]

        self.last_results = dict(zip(names, drained))
        metrics: dict = {"models": {
            name: res.metrics()
            for name, res in self.last_results.items()}}
        metrics["total"] = _aggregate_totals(self.last_results,
                                             self.timeline)
        return metrics
