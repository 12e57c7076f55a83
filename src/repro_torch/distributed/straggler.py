"""Straggler mitigation + step journal for fault-tolerant training loops;
port of ``repro/distributed/straggler.py`` (pure Python, the same code).

Two pieces, both host-side (the device program stays SPMD/deterministic):

* ``StragglerMonitor`` — tracks per-step wall time; a step slower than
  ``threshold`` x the trailing median flags a straggler event. The
  launcher's policy on repeated events is: snapshot -> re-plan the mesh
  over the ranks (``elastic.replan_mesh``) -> reshard -> resume
  (``launch.train.remesh``, with the event or-ed over the ranks so that
  all take it); on one rank it reports the event.
  Detection must be cheap and false-positive-robust, hence median +
  hysteresis rather than mean.

* ``StepJournal`` — append-only JSONL of (step, data_offset, rng_seed,
  checkpoint). After a crash, replay = seek the data stream to the
  journaled offset and restore the newest checkpoint <= that step:
  skip-and-replay gives exactly-once step semantics without coordinating
  a distributed snapshot on every step.
"""
from __future__ import annotations

import json
import os
import statistics
import time
from typing import Optional


class StragglerMonitor:
    def __init__(self, *, window: int = 32, threshold: float = 2.0,
                 hysteresis: int = 3):
        self.window = window
        self.threshold = threshold
        self.hysteresis = hysteresis
        self.times: list[float] = []
        self.flags = 0
        self.events: list[dict] = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> bool:
        """Record a step; True => persistent straggler (act now)."""
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        baseline = statistics.median(self.times[-self.window:]) \
            if len(self.times) >= 8 else None
        self.times.append(dt)
        if baseline is not None and dt > self.threshold * baseline:
            self.flags += 1
            self.events.append({"step": step, "seconds": dt,
                                "median": baseline})
            if self.flags >= self.hysteresis:
                self.flags = 0
                return True
        else:
            self.flags = max(0, self.flags - 1)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        return {"steps": len(self.times),
                "median_s": statistics.median(self.times),
                "p95_s": sorted(self.times)[int(0.95 * len(self.times))],
                "straggler_events": len(self.events)}


class StepJournal:
    """Append-only recovery journal (one JSON line per step)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def record(self, step: int, *, data_offset: int, seed: int,
               checkpoint_step: Optional[int] = None, **extra):
        entry = {"step": step, "data_offset": data_offset, "seed": seed,
                 "checkpoint_step": checkpoint_step, "t": time.time(),
                 **extra}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def replay_point(self) -> Optional[dict]:
        """Last journaled entry — where to resume after a crash."""
        if not os.path.exists(self.path):
            return None
        last = None
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        last = json.loads(line)
                    except json.JSONDecodeError:
                        break       # torn tail write from the crash
        return last
