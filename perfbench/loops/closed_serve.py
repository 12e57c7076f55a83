"""The ``closed_serve`` loop: ``clients`` closed-loop clients on the
server's event loop, each awaiting ``AsyncServer.submit`` for one train
of the pool and then sending the next, under ``BatchPolicy(max_batch,
max_wait_us, buckets)`` with every bucket captured at
``ProgramRegistry.register(precompile=...)``; ``warmup_requests_per_client``
requests each before the window; every answer kept."""
from __future__ import annotations

import asyncio
import time

import numpy as np

from perfbench.network import rng_for
from perfbench.workload import Window

MODEL = "net"


class Loop:
    span = "serve.loop"

    def __init__(self, program, spec, pool, mix, seed, tracer):
        self.program, self.spec, self.pool, self.mix, self.tracer = (
            program, spec, pool, mix, tracer)
        self.seed = seed
        self.records: list[tuple[int, object]] = []
        self.missing = 0
        self.server: dict = {}

    def prepare(self) -> None:
        from repro_torch.serve.batcher import BatchPolicy
        from repro_torch.serve.registry import ProgramRegistry
        m = self.mix
        self.policy = BatchPolicy(max_batch=m["max_batch"],
                                  max_wait_us=m["max_wait_us"],
                                  buckets=tuple(m["buckets"]))
        tracer = self.tracer

        class Registry(ProgramRegistry):
            """Wraps each engine call in the benchmark's span."""

            def runner(self, name, spec=None, **kw):
                call = super().runner(name, spec, **kw)

                def spanned(ext):
                    with tracer.span("engine.run"):
                        return call(ext)
                return spanned

        self.registry = (Registry if tracer.on else ProgramRegistry)()
        self.registry.register(MODEL, self.program, precompile=self.policy,
                               timesteps=self.pool.shape[1], spec=self.spec,
                               policy=self.policy)

    def direct_input(self) -> np.ndarray:
        return np.ascontiguousarray(self.pool[:self.mix["max_batch"]])

    def info(self) -> dict:
        return {"server": self.server}

    per_call = 1                # a request a completion

    def measure(self, seconds: float, on_open) -> Window:
        return asyncio.run(self._measure(seconds, on_open))

    async def _measure(self, seconds: float, on_open) -> Window:
        from repro_torch.serve.async_server import AsyncServer
        from repro_torch.serve.server import Request
        pool, n_clients = self.pool, self.mix["clients"]
        rngs = [rng_for(self.seed, 4, c) for c in range(n_clients)]
        done: list[tuple] = []          # (pool index, t_sent, t_done, r)
        failed = [0]

        async def client(c: int, n: int | None, until: float | None):
            rng, i = rngs[c], 0
            while (i < n) if n is not None else (time.perf_counter()
                                                 < until):
                idx = int(rng.integers(len(pool)))
                sent = time.perf_counter()
                try:
                    r = await srv.submit(Request(MODEL, pool[idx], 0.0,
                                                 stream=c))
                except Exception:       # counted; the comparison fails it
                    failed[0] += 1
                    continue
                finally:
                    i += 1
                if until is not None:
                    done.append((idx, sent, time.perf_counter(), r))

        srv = AsyncServer(self.registry, spec=self.spec)
        async with srv:
            await asyncio.gather(*(client(c, self.mix[
                "warmup_requests_per_client"], None)
                for c in range(n_clients)))
            on_open()
            with self.tracer.span(self.span):
                t0 = time.perf_counter()
                t1 = t0 + seconds
                await asyncio.gather(*(client(c, None, t1)
                                       for c in range(n_clients)))
            m = srv.metrics()
            self.server = {"stages_us": m["total"]["stages_us"],
                           "batches_all": sum(x["batches"] for x in
                                              m["models"].values())}
        in_window = [d for d in done if d[2] <= t1]
        self.records = [(d[0], d[3]) for d in done]
        self.missing = failed[0]
        return Window(t0, t1, len(done) + failed[0], failed[0],
                      len(in_window), "requests", 0,
                      batches=sum(1.0 / d[3].batch_size for d in in_window),
                      latencies_s=[d[2] - d[1] for d in in_window],
                      done_at=[d[2] for d in in_window])

    def compare(self, exp, tally) -> None:
        for idx, r in self.records:
            spikes, v, pkts = r.outputs
            tally.add(exp, idx, spikes, v, pkts)
        tally.counts["missing"] += self.missing
