"""The ``offline`` loop: ``Program.run`` back to back on batches of
``batch`` trains, from a ring of ``ring`` input arrays, each drawn from
the seed as rows of a permutation of the pool. Before each call one row
of the array it gets is overwritten by the next pool row of a stream
drawn from the seed (span ``input.prep``, a row's copy), so that no call
sees the contents of an earlier one: a cache keyed by the array gives
wrong answers, and one keyed by its contents has to read it all.
``sampled_calls`` calls' outputs are copied, with the rows they were
given, into room made in set-up, by a reservoir drawn from the seed;
``warmup_calls`` calls come before the window. Each call's wall time, from ``Program.run`` to its
return with the outputs on the host, is the window's latency."""
from __future__ import annotations

import random
import time

import numpy as np

from perfbench.network import rng_for
from perfbench.workload import Window


def _permutations(rng, n: int, need: int) -> np.ndarray:
    return np.concatenate([rng.permutation(n)
                           for _ in range(-(-need // n))])[:need]


class Loop:
    span = "bench.loop"

    def __init__(self, program, spec, pool, mix, seed, tracer):
        self.program, self.spec, self.mix, self.tracer = (program, spec,
                                                          mix, tracer)
        self.batch = mix["batch"]
        rng = rng_for(seed, 3)
        self.rows = _permutations(rng, len(pool), self.batch * mix["ring"]
                                  ).reshape(mix["ring"], self.batch)
        self.ring = [np.ascontiguousarray(pool[r]) for r in self.rows]
        self.stream = _permutations(rng, len(pool), 8 * len(pool))
        self.pool = pool
        self._pick = random.Random(int(rng_for(seed, 5).integers(2**62))
                                   ).randrange

    def prepare(self) -> None:
        self.program.precompile([self.batch], self.pool.shape[1],
                                self.spec)

    def _next(self, n: int) -> int:
        """Call ``n``'s array, with its next row overwritten."""
        k = n % len(self.ring)
        j = (n // len(self.ring)) % self.batch
        r = self.stream[n % len(self.stream)]
        self.ring[k][j] = self.pool[r]
        self.rows[k, j] = r
        return k

    def _slots(self, out) -> None:
        """Room for ``sampled_calls`` calls' outputs, shaped after one
        call's and written through in set-up: a call kept in the window
        is copied into memory that is already there, where holding on to
        its own arrays would make the calls after it allocate afresh."""
        m = self.mix["sampled_calls"]
        spikes, v, stats = out
        self.slots = [np.full((m,) + np.shape(a), 1, np.asarray(a).dtype)
                      for a in (spikes, v, stats["packet_counts"])]
        self.slot_rows = np.zeros((m, self.batch), self.rows.dtype)
        self.n_kept = self.misshaped = 0

    def _keep(self, n: int, k: int, out) -> None:
        """Reservoir sampling: every call equally likely to be kept."""
        j = self.n_kept
        if j < len(self.slot_rows):
            self.n_kept += 1
        else:
            j = self._pick(n + 1)
            if j >= len(self.slot_rows):
                return
        spikes, v, stats = out
        got = (spikes, v, stats["packet_counts"])
        if any(np.shape(a) != b.shape[1:] for a, b in zip(got, self.slots)):
            self.misshaped += 1         # an answer of the wrong shape
            return
        for buf, a in zip(self.slots, got):
            buf[j] = a
        self.slot_rows[j] = self.rows[k]

    def measure(self, seconds: float, on_open) -> Window:
        run, ring, spec = self.program.run, self.ring, self.spec
        warm = self.mix["warmup_calls"]
        for n in range(warm):
            out = run(ring[self._next(n)], spec)
        self._slots(out)
        on_open()
        span = self.tracer.span
        calls, done_at, lat = 0, [], []
        clock = time.perf_counter
        with span(self.span):
            t0 = clock()
            end = t0 + seconds
            while True:
                with span("input.prep"):
                    k = self._next(warm + calls)
                with span("engine.run"):
                    sent = clock()
                    out = run(ring[k], spec)
                    t1 = clock()
                lat.append(t1 - sent)
                self._keep(calls, k, out)
                calls += 1
                done_at.append(t1)
                if t1 >= end:
                    break
        return Window(t0, t1, calls, 0, calls * self.batch, "samples",
                      calls, latencies_s=lat, done_at=done_at)

    def direct_input(self) -> np.ndarray:
        return self.ring[0]

    def info(self) -> dict:
        return {}

    per_call = property(lambda self: self.batch)   # trains a call

    def compare(self, exp, tally) -> None:
        spikes, v, pkts = self.slots
        for j in range(self.n_kept):
            tally.add(exp, self.slot_rows[j], spikes[j], v[j], pkts[j])
        tally.counts["spikes_off"] += self.misshaped
