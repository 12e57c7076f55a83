"""Trace replay: sustained-load soak testing on the simulated clock;
port of ``repro/serve/replay.py``, the same numpy logic copied, so the
same traces, policies and service models give the same reports bit for
bit, and a trace saved by either package loads in the other.

The serving stack's policy semantics live in an event-driven
simulation (:mod:`repro_torch.serve.batcher`), so soak testing is replay:
generate (or load) an arrival trace, drain it through the same
``MicroBatcher``/``drain_together`` code path the server uses, and
read the percentiles. Everything is deterministic — the same seed
produces the same trace, and the same trace produces bit-identical
per-request latencies — so p99/SLO and shed-rate bounds can be
*asserted*, not eyeballed.

:class:`ArrivalTrace` holds arrival times + client-stream tags and
builds the two canonical synthetic workloads:

* :meth:`ArrivalTrace.poisson` — memoryless arrivals at a target QPS;
* :meth:`ArrivalTrace.bursty` — periodic on/off modulation (an
  on-window at ``burst_factor`` × the base rate), the event-camera /
  market-data shape that actually stresses bounded queues.

:func:`replay` drains one trace per model against one shared engine
(or per-engine clocks) and returns a :class:`SoakReport` whose
``check``/``assert_slo`` encode the acceptance bars. Stage latencies
sum bit-exactly to end-to-end latency here for the same reason they do
everywhere else: the drain loop *defines* latency as that sum.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.serve.batcher import (BatchPolicy, DrainResult,
                                       MicroBatcher, SHED_REASONS,
                                       drain_together)

_TRACE_KINDS = ("poisson", "bursty", "recorded")


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A replayable arrival process: times (µs, nondecreasing) plus a
    client-stream tag per request and the generator's metadata."""
    arrivals_us: np.ndarray
    streams: np.ndarray
    duration_us: float
    kind: str = "recorded"
    seed: int | None = None

    def __post_init__(self):
        arr = np.asarray(self.arrivals_us, np.float64)
        if arr.ndim != 1:
            raise ValueError(f"arrivals_us must be 1-D, got {arr.shape}")
        if len(arr) > 1 and np.any(np.diff(arr) < 0):
            raise ValueError("arrivals_us must be nondecreasing")
        streams = np.asarray(self.streams, np.int64)
        if streams.shape != arr.shape:
            raise ValueError(f"streams shape {streams.shape} != arrivals "
                             f"shape {arr.shape}")
        if self.duration_us <= 0:
            raise ValueError(f"duration_us must be > 0, "
                             f"got {self.duration_us}")
        if self.kind not in _TRACE_KINDS:
            raise ValueError(f"kind must be one of {_TRACE_KINDS}, "
                             f"got {self.kind!r}")
        object.__setattr__(self, "arrivals_us", arr)
        object.__setattr__(self, "streams", streams)

    @property
    def n_requests(self) -> int:
        return len(self.arrivals_us)

    @property
    def duration_s(self) -> float:
        return self.duration_us / 1e6

    @property
    def offered_qps(self) -> float:
        return self.n_requests / self.duration_s

    # -- synthetic generators ------------------------------------------------

    @classmethod
    def poisson(cls, qps: float, duration_s: float, *, seed: int = 0,
                n_streams: int = 1) -> "ArrivalTrace":
        """Memoryless arrivals at ``qps`` for ``duration_s`` simulated
        seconds; streams are assigned round-robin-free (iid uniform)
        so FIFO-per-stream is a real property, not an artifact."""
        if qps <= 0 or duration_s <= 0:
            raise ValueError(f"qps and duration_s must be > 0, got "
                             f"{qps}, {duration_s}")
        rng = np.random.default_rng(seed)
        horizon = duration_s * 1e6
        # draw enough exponential gaps to cover the window w.h.p.,
        # then truncate — keeps generation O(n) and deterministic
        n_draw = max(16, int(qps * duration_s * 1.25) + 64)
        gaps = rng.exponential(1e6 / qps, n_draw)
        t = np.cumsum(gaps)
        while t[-1] < horizon:                 # pragma: no cover (rare)
            extra = rng.exponential(1e6 / qps, n_draw)
            t = np.concatenate([t, t[-1] + np.cumsum(extra)])
        t = t[t < horizon]
        streams = rng.integers(0, n_streams, len(t))
        return cls(t, streams, horizon, kind="poisson", seed=seed)

    @classmethod
    def bursty(cls, qps: float, duration_s: float, *, seed: int = 0,
               n_streams: int = 1, burst_factor: float = 4.0,
               period_s: float = 1.0, duty: float = 0.2) -> "ArrivalTrace":
        """On/off modulated Poisson averaging ``qps``: each
        ``period_s`` window spends ``duty`` of its span at
        ``burst_factor`` × the base rate and the rest at the
        complementary low rate (floored at 0), so the mean rate stays
        ``qps`` while bursts probe queue bounds and deadlines."""
        if not 0 < duty < 1:
            raise ValueError(f"duty must be in (0, 1), got {duty}")
        if burst_factor < 1:
            raise ValueError(f"burst_factor must be >= 1, "
                             f"got {burst_factor}")
        hi = qps * burst_factor
        lo = max((qps - duty * hi) / (1.0 - duty), 0.0)
        rng = np.random.default_rng(seed)
        horizon = duration_s * 1e6
        period_us = period_s * 1e6
        on_us = duty * period_us
        chunks = []
        start = 0.0
        while start < horizon:
            for rate, t0, t1 in ((hi, start, start + on_us),
                                 (lo, start + on_us, start + period_us)):
                t1 = min(t1, horizon)
                if rate <= 0 or t1 <= t0:
                    continue
                span = t1 - t0
                n_draw = max(4, int(rate / 1e6 * span * 1.5) + 32)
                t = t0 + np.cumsum(rng.exponential(1e6 / rate, n_draw))
                while t[-1] < t1:              # pragma: no cover (rare)
                    extra = rng.exponential(1e6 / rate, n_draw)
                    t = np.concatenate([t, t[-1] + np.cumsum(extra)])
                chunks.append(t[t < t1])
            start += period_us
        arrivals = (np.concatenate(chunks) if chunks
                    else np.zeros(0))
        streams = rng.integers(0, n_streams, len(arrivals))
        return cls(arrivals, streams, horizon, kind="bursty", seed=seed)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """Write the trace as ``.npz`` (portable, seed-independent)."""
        np.savez(Path(path), arrivals_us=self.arrivals_us,
                 streams=self.streams,
                 duration_us=np.float64(self.duration_us),
                 kind=np.str_(self.kind),
                 seed=np.int64(-1 if self.seed is None else self.seed))

    @classmethod
    def load(cls, path: str | Path) -> "ArrivalTrace":
        with np.load(Path(path)) as z:
            seed = int(z["seed"])
            return cls(z["arrivals_us"], z["streams"],
                       float(z["duration_us"]), kind=str(z["kind"]),
                       seed=None if seed < 0 else seed)


@dataclasses.dataclass
class SoakReport:
    """Aggregate view of one replay, with assertable acceptance bars.

    ``results`` holds the per-queue :class:`DrainResult`\\ s (full
    per-request accounting); the scalar fields are computed over every
    queue's served requests on the replay timeline.
    """
    results: dict[str, DrainResult]
    sim_seconds: float
    offered_qps: float
    requests: int
    served: int
    shed: dict[str, int]
    p50_ms: float
    p99_ms: float
    mean_ms: float
    stages_us: dict[str, float]
    stage_sum_exact: bool

    @property
    def shed_frac(self) -> float:
        return ((self.requests - self.served) / self.requests
                if self.requests else 0.0)

    @property
    def deadline_miss_frac(self) -> float:
        return (self.shed["deadline"] / self.requests
                if self.requests else 0.0)

    def fingerprint(self) -> tuple:
        """Bit-level digest for determinism checks: two replays of the
        same trace must produce equal fingerprints."""
        lat = np.concatenate(
            [r.latencies_us[r.served] for r in self.results.values()]
            or [np.zeros(0)])
        return (self.requests, self.served, tuple(sorted(self.shed.items())),
                lat.tobytes())

    def check(self, *, slo_p99_ms: float | None = None,
              max_shed_frac: float | None = None,
              max_deadline_miss_frac: float | None = None) -> list[str]:
        """Violated acceptance bars as human-readable strings
        (empty == pass). Stage-sum exactness is always checked."""
        bad = []
        if not self.stage_sum_exact:
            bad.append("stage latencies do not sum bit-exactly to "
                       "latencies_us")
        if slo_p99_ms is not None and self.p99_ms > slo_p99_ms:
            bad.append(f"p99 {self.p99_ms:.3f} ms > SLO {slo_p99_ms} ms")
        if max_shed_frac is not None and self.shed_frac > max_shed_frac:
            bad.append(f"shed_frac {self.shed_frac:.4f} > bound "
                       f"{max_shed_frac}")
        if (max_deadline_miss_frac is not None
                and self.deadline_miss_frac > max_deadline_miss_frac):
            bad.append(f"deadline_miss_frac {self.deadline_miss_frac:.4f} "
                       f"> bound {max_deadline_miss_frac}")
        return bad

    def assert_slo(self, **bounds) -> None:
        """Raise ``AssertionError`` listing every violated bar."""
        bad = self.check(**bounds)
        if bad:
            raise AssertionError("soak SLO violated:\n"
                                 + "\n".join(f"  - {b}" for b in bad))


def _as_map(value, names: list[str], what: str) -> dict:
    if isinstance(value, dict):
        missing = [n for n in names if n not in value]
        if missing:
            raise ValueError(f"no {what} for trace(s) {missing}")
        return value
    return {n: value for n in names}


def replay(traces, policy=None, service_model=None, *,
           shared: bool = True) -> SoakReport:
    """Replay arrival trace(s) through the drain simulation.

    traces: one :class:`ArrivalTrace` or ``{model_name: trace}``.
    policy: one :class:`BatchPolicy` or ``{model_name: policy}``
        (default ``BatchPolicy()``).
    service_model: ``bucket -> µs`` callable or ``{name: callable}``
        — required; replay is pure simulation, no engine runs.
    shared: ``True`` drains every queue against ONE serially-busy
        engine (the server's default timeline); ``False`` gives each
        queue its own engine clock.
    """
    if isinstance(traces, ArrivalTrace):
        traces = {"model": traces}
    if not traces:
        raise ValueError("need at least one trace to replay")
    names = sorted(traces)
    if service_model is None:
        raise ValueError("replay needs a service_model (bucket -> µs); "
                         "soak runs are pure simulation")
    policies = _as_map(policy if policy is not None else BatchPolicy(),
                       names, "policy")
    models = _as_map(service_model, names, "service_model")
    items = [(MicroBatcher(policies[n], service_model=models[n]),
              traces[n].arrivals_us, None) for n in names]
    if shared:
        drained = drain_together(items)
    else:
        drained = [b.drain(arr) for b, arr, _ in items]
    results = dict(zip(names, drained))

    lat = np.concatenate([r.latencies_us[r.served]
                          for r in results.values()])
    requests = sum(r.n_requests for r in results.values())
    served = sum(r.n_served for r in results.values())
    shed = {name: 0 for name in SHED_REASONS.values()}
    exact = True
    stage_cat: dict[str, list] = {"queue_wait": [], "batch_fill": [],
                                  "pad": [], "compute": []}
    for r in results.values():
        for k, v in r.shed_counts().items():
            shed[k] += v
        s = r.served
        exact = exact and bool(
            np.array_equal(r.stage_sum()[s], r.latencies_us[s]))
        stage_cat["queue_wait"].append(r.queue_wait_us[s])
        stage_cat["batch_fill"].append(r.fill_wait_us[s])
        stage_cat["pad"].append(r.pad_us[s])
        stage_cat["compute"].append(r.compute_us[s])
    sim_seconds = max(t.duration_s for t in traces.values())
    p50, p99 = (np.percentile(lat, [50, 99]) if len(lat)
                else (0.0, 0.0))
    return SoakReport(
        results=results,
        sim_seconds=sim_seconds,
        offered_qps=requests / sim_seconds,
        requests=requests,
        served=served,
        shed=shed,
        p50_ms=float(p50) / 1e3,
        p99_ms=float(p99) / 1e3,
        mean_ms=float(lat.mean()) / 1e3 if len(lat) else 0.0,
        stages_us={k: (float(np.concatenate(v).mean()) if served else 0.0)
                   for k, v in stage_cat.items()},
        stage_sum_exact=exact,
    )
