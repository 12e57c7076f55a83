"""Real-time asyncio serving front end with admission control; port of
``repro/serve/async_server.py`` over the port's registry and engines.

Where :class:`~repro_torch.serve.server.Server` *simulates* a serving loop
on a deterministic clock (drain a recorded stream, get exact
metrics), :class:`AsyncServer` *is* one: callers ``await submit(...)``
concurrently, every model owns a bounded FIFO queue drained by one
worker task, and overload surfaces as exceptions at the submission
site — explicit backpressure instead of unbounded queue growth.

The :class:`~repro_torch.serve.batcher.BatchPolicy` semantics are the same
as the simulated batcher's, applied to the real clock:

* admission control at ``submit``: a full queue (``max_queue``)
  rejects the arrival (:class:`QueueFullError`), sheds the oldest
  waiting request (``drop-oldest`` — *that* submitter's await raises),
  or admits anyway and degrades batch sizing (``degrade``);
* the worker holds a partial batch up to ``max_wait_us`` (deadline-
  aware: it never holds a head past its dispatch deadline), pads to
  the policy bucket, and runs the engine serially per model;
* requests still queued past ``arrival + deadline_us`` are failed
  with :class:`DeadlineMissError` — shed requests NEVER execute.

Per-request latency decomposes into the same four stages as
:class:`~repro_torch.serve.batcher.DrainResult` (queue wait / batch fill /
pad / compute), measured from real timestamps but *defined* as the
stage sum, so ``queue_wait_us + fill_wait_us + pad_us + compute_us ==
latency_us`` holds bit-exactly here too.

Execution: with a ``service_model`` the server sleeps the modeled
service time (pure policy behavior, no engine); without one it runs
the model's registry runner in a thread executor and the measured wall
time of ``runner(batch)`` is the service time. On the card:

* **the device in the executor thread.** ``_run_engine`` makes the
  engine's device current in the executor thread before it calls the
  runner: the kernels' ctypes launches and a graph replay take the
  current device's current stream. The runner (and so its device) is
  resolved at :meth:`AsyncServer.start`, which raises there when the
  spec names the card and none is present;
* **one engine, one caller.** A captured shape replays over the
  engine's static buffers, so one engine must never run two batches at
  once. Each model has ONE worker, which awaits its batch before it
  takes the next, and two models never share an engine (the registry's
  engines live on each ``Program``);
* **no capture while workers run.** A CUDA graph capture fails if
  another thread launches during it, so serving shapes are captured at
  ``ProgramRegistry.register(precompile=...)``, before :meth:`start`.
  A batch of a shape not captured runs the engine's loop eagerly;
* **compute time is honest** because ``engine.run`` ends in the copies
  of its outputs to the host, so the runner returns only when the card
  has finished the batch.

Unlike the reference, a runner that raises fails the awaits of its
batch with that error and the worker goes on serving (the reference's
worker task ends and leaves those awaits pending).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.execution import as_spec
from repro_torch.kernels import _build
from repro_torch.serve.batcher import BatchPolicy, latency_metrics
from repro_torch.serve.registry import ProgramRegistry
from repro_torch.serve.server import Request


class ShedError(RuntimeError):
    """A submitted request was shed instead of served."""
    reason = "shed"


class QueueFullError(ShedError):
    """Admission control rejected the request: the model queue was
    full (shed policy ``reject``), or the request was the oldest
    waiting when a newer one arrived (``drop-oldest``)."""
    reason = "queue_full"


class DeadlineMissError(ShedError):
    """The request was still queued past ``arrival + deadline_us``."""
    reason = "deadline"


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    """What a successful ``await submit(...)`` resolves to."""
    model: str
    stream: int
    latency_us: float                 # == the stage sum, bit-exactly
    queue_wait_us: float
    fill_wait_us: float
    pad_us: float
    compute_us: float
    bucket: int
    batch_size: int
    degraded: bool
    outputs: tuple | None = None      # (spikes [T,·], v [·], pkts [T])


@dataclasses.dataclass
class _Pending:
    ext: np.ndarray
    stream: int
    t_enq_us: float
    future: asyncio.Future


class AsyncServer:
    """Asyncio service over a :class:`ProgramRegistry`.

    Use as an async context manager or call ``start()``/``stop()``::

        async with AsyncServer(registry, policy=pol) as srv:
            done = await srv.submit(Request("m", ext, 0.0))

    Policy resolution per model: ``policies[name]`` > the policy
    registered with the model > ``policy``. ``clock`` injects a µs
    timestamp source (default ``time.monotonic``-based) — timestamps
    only feed metrics, never control flow ordering.
    """

    def __init__(self, registry: ProgramRegistry, *,
                 policy: BatchPolicy | None = None,
                 policies: dict[str, BatchPolicy] | None = None,
                 service_model=None, spec=None, clock=None):
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.policies = dict(policies or {})
        self.service_model = service_model
        self.spec = spec
        self._clock = clock or (lambda: time.monotonic() * 1e6)
        self._queues: dict[str, deque[_Pending]] = {}
        self._conds: dict[str, asyncio.Condition] = {}
        self._workers: dict[str, asyncio.Task] = {}
        self._free_us: dict[str, float] = {}
        self._completed: dict[str, list[CompletedRequest]] = {}
        self._completion_ts: dict[str, list[float]] = {}
        self._shed: dict[str, dict[str, int]] = {}
        self._degraded_batches: dict[str, int] = {}
        self._batch_count: dict[str, int] = {}
        self._dequeued: dict[str, int] = {}   # requests taken off a queue
        self._runners: dict[str, tuple] = {}  # engine mode: (runner, device)
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "AsyncServer":
        if self._running:
            raise RuntimeError("AsyncServer already started")
        if self.service_model is None:     # engine mode: resolve each
            for name in self.registry.names():   # runner and its device
                program = self.registry.get(name)
                spec = as_spec(self.spec, program.default_engine).resolve()
                self._runners[name] = (self.registry.runner(name, self.spec),
                                       torch.device(spec.device))
        self._running = True
        now = self._clock()
        for name in self.registry.names():
            self._queues[name] = deque()
            self._conds[name] = asyncio.Condition()
            self._free_us[name] = now
            self._completed[name] = []
            self._completion_ts[name] = []
            self._shed[name] = {"queue_full": 0, "deadline": 0}
            self._degraded_batches[name] = 0
            self._batch_count[name] = 0
            self._dequeued[name] = 0
            self._workers[name] = asyncio.create_task(
                self._worker(name), name=f"serve-{name}")
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop the workers. ``drain=True`` serves everything already
        queued first; ``drain=False`` fails pending requests with
        :class:`ShedError` immediately."""
        self._running = False
        if not drain:
            for name, q in self._queues.items():
                while q:
                    p = q.popleft()
                    if not p.future.done():
                        p.future.set_exception(
                            ShedError(f"server for model {name!r} stopped "
                                      f"without draining"))
        for cond in self._conds.values():
            async with cond:
                cond.notify_all()
        for task in self._workers.values():
            await task
        self._workers.clear()

    async def __aenter__(self) -> "AsyncServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission (admission control happens HERE) ------------------------

    def policy_for(self, name: str) -> BatchPolicy:
        if name in self.policies:
            return self.policies[name]
        registered = self.registry.policy(name)
        return registered if registered is not None else self.policy

    async def submit(self, request: Request) -> CompletedRequest:
        """Submit one request; resolves when served, raises
        :class:`QueueFullError`/:class:`DeadlineMissError` when shed.
        ``request.arrival_us`` is ignored — the real clock stamps the
        arrival."""
        if not self._running:
            raise RuntimeError("AsyncServer not started")
        name = request.model
        if name not in self._queues:
            raise KeyError(f"request for unregistered model {name!r}; "
                           f"have {tuple(sorted(self._queues))}")
        pol = self.policy_for(name)
        q = self._queues[name]
        if (pol.max_queue > 0 and len(q) >= pol.max_queue
                and pol.shed != "degrade"):
            if pol.shed == "reject":
                self._shed[name]["queue_full"] += 1
                raise QueueFullError(
                    f"model {name!r} queue full "
                    f"({len(q)} waiting >= max_queue={pol.max_queue})")
            oldest = q.popleft()           # drop-oldest
            self._shed[name]["queue_full"] += 1
            if not oldest.future.done():
                oldest.future.set_exception(QueueFullError(
                    f"model {name!r} shed the oldest waiting request "
                    f"(drop-oldest, max_queue={pol.max_queue})"))
        pending = _Pending(np.asarray(request.ext), request.stream,
                           self._clock(),
                           asyncio.get_running_loop().create_future())
        q.append(pending)
        cond = self._conds[name]
        async with cond:
            cond.notify_all()
        return await pending.future

    # -- the per-model worker -----------------------------------------------

    async def _fill_batch(self, name: str, pol: BatchPolicy) -> None:
        """Hold for the batch to fill: up to ``max_wait_us`` from the
        head's enqueue (deadline-aware), ended early by a full batch,
        overload (degrade mode), or shutdown."""
        q = self._queues[name]
        cond = self._conds[name]
        head = q[0]
        hold_until = head.t_enq_us + pol.max_wait_us
        if pol.deadline_us > 0:
            hold_until = min(hold_until, head.t_enq_us + pol.deadline_us)
        while (self._running and q and q[0] is head
               and len(q) < pol.max_batch
               and not (pol.shed == "degrade" and pol.max_queue > 0
                        and len(q) > pol.max_queue)):
            remaining_s = (hold_until - self._clock()) / 1e6
            if remaining_s <= 0:
                return
            async with cond:
                try:
                    await asyncio.wait_for(cond.wait(), remaining_s)
                except asyncio.TimeoutError:
                    return

    def _run_engine(self, runner, batch: np.ndarray, device: torch.device):
        """Run one batch in an executor thread, the engine's device
        current (a new thread starts on device 0)."""
        with _build.on_device(device):
            return runner(batch)

    async def _worker(self, name: str) -> None:
        q = self._queues[name]
        cond = self._conds[name]
        pol = self.policy_for(name)
        runner, device = self._runners.get(name, (None, None))
        loop = asyncio.get_running_loop()
        while True:
            async with cond:
                while self._running and not q:
                    await cond.wait()
            if not q:
                if not self._running:
                    return
                continue
            if pol.max_wait_us > 0 and len(q) < pol.max_batch:
                await self._fill_batch(name, pol)
            # deadline purge: shed everything already past its deadline
            now = self._clock()
            while q and pol.deadline_us > 0 and \
                    q[0].t_enq_us + pol.deadline_us < now:
                p = q.popleft()
                self._shed[name]["deadline"] += 1
                if not p.future.done():
                    p.future.set_exception(DeadlineMissError(
                        f"model {name!r} request queued "
                        f"{(now - p.t_enq_us):.0f}us > deadline_us="
                        f"{pol.deadline_us:.0f}"))
            if not q:
                continue
            degraded = (pol.shed == "degrade" and pol.max_queue > 0
                        and len(q) > pol.max_queue)
            n = (pol.degrade_size(len(q)) if degraded
                 else min(len(q), pol.max_batch))
            members = [q.popleft() for _ in range(n)]
            self._dequeued[name] += n
            bucket = pol.bucket_of(n)
            dispatch = self._clock()
            outputs = None
            if runner is not None:
                batch = np.stack([p.ext for p in members])
                if n < bucket:
                    pad = np.zeros((bucket - n,) + batch.shape[1:],
                                   batch.dtype)
                    batch = np.concatenate([batch, pad])
                try:
                    spikes, v, stats = await loop.run_in_executor(
                        None, self._run_engine, runner, batch, device)
                except Exception as err:   # the batch's awaits raise it;
                    for p in members:      # the worker serves on
                        if not p.future.done():
                            p.future.set_exception(err)
                    self._free_us[name] = self._clock()
                    continue
                pkts = np.asarray(stats["packet_counts"])[:n]
                outputs = (spikes[:n], v[:n], pkts)
            else:
                await asyncio.sleep(self.service_model(bucket) / 1e6)
            completion = self._clock()
            service_us = completion - dispatch
            free_before = self._free_us[name]
            pad_ratio = (bucket - n) / bucket
            for j, p in enumerate(members):
                wait = dispatch - p.t_enq_us
                q_wait = min(wait, max(0.0, free_before - p.t_enq_us))
                f_wait = wait - q_wait
                pad_v = service_us * pad_ratio
                cu_v = service_us - pad_v
                done = CompletedRequest(
                    model=name, stream=p.stream,
                    latency_us=((q_wait + f_wait) + pad_v) + cu_v,
                    queue_wait_us=q_wait, fill_wait_us=f_wait,
                    pad_us=pad_v, compute_us=cu_v, bucket=bucket,
                    batch_size=n, degraded=degraded,
                    outputs=(None if outputs is None else
                             (outputs[0][j], outputs[1][j], outputs[2][j])))
                self._completed[name].append(done)
                self._completion_ts[name].append(completion)
                if not p.future.done():
                    p.future.set_result(done)
            self._free_us[name] = completion
            self._batch_count[name] += 1
            if degraded:
                self._degraded_batches[name] += 1

    # -- metrics ------------------------------------------------------------

    def metrics(self) -> dict:
        """Same shape as ``Server.serve``'s dict: per-model + total
        latency/shed/stage accounting from everything served so far."""
        models: dict[str, dict] = {}
        all_lat: list[float] = []
        all_comp: list[float] = []
        total_shed = {"queue_full": 0, "deadline": 0}
        stage_tot = {"queue_wait": 0.0, "batch_fill": 0.0, "pad": 0.0,
                     "compute": 0.0}
        n_total = 0
        for name in self._completed:
            done = self._completed[name]
            lat = np.asarray([c.latency_us for c in done])
            comp = np.asarray(self._completion_ts[name])
            m = latency_metrics(lat, comp)
            m["batches"] = self._batch_count[name]
            shed = dict(self._shed[name])
            n_req = len(done) + sum(shed.values())
            m["shed"] = shed
            m["shed_frac"] = (sum(shed.values()) / n_req) if n_req else 0.0
            m["deadline_misses"] = shed["deadline"]
            m["degraded_batches"] = self._degraded_batches[name]
            m["stages_us"] = {
                "queue_wait": float(np.mean([c.queue_wait_us
                                             for c in done])) if done
                else 0.0,
                "batch_fill": float(np.mean([c.fill_wait_us
                                             for c in done])) if done
                else 0.0,
                "pad": float(np.mean([c.pad_us for c in done])) if done
                else 0.0,
                "compute": float(np.mean([c.compute_us
                                          for c in done])) if done
                else 0.0,
            }
            models[name] = m
            all_lat.extend(lat.tolist())
            all_comp.extend(comp.tolist())
            for k in total_shed:
                total_shed[k] += shed[k]
            for c in done:
                stage_tot["queue_wait"] += c.queue_wait_us
                stage_tot["batch_fill"] += c.fill_wait_us
                stage_tot["pad"] += c.pad_us
                stage_tot["compute"] += c.compute_us
            n_total += n_req
        total = latency_metrics(np.asarray(all_lat), np.asarray(all_comp))
        total["models"] = len(models)
        total["timeline"] = "real"
        total["shed"] = total_shed
        total["shed_frac"] = (sum(total_shed.values()) / n_total
                              if n_total else 0.0)
        total["deadline_misses"] = total_shed["deadline"]
        n_done = len(all_lat)
        total["stages_us"] = {k: (v / n_done if n_done else 0.0)
                              for k, v in stage_tot.items()}
        return {"models": models, "total": total}
