"""The traffic driver: a mix file (``traffic/<mix>.json``) names its
``loop``, found by name in ``loops/<loop>.py`` (a class ``Loop``: the
``offline`` and ``closed_serve`` loops so far), and its other keys set
the sizes; ``kernel``, where a mix gives it, picks the engine's tier
(the ``"fused"`` default otherwise). Each loop warms every shape it
uses before the window opens and times the window on the host's clock,
ending at a completed call; ``Window`` is what it hands back."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    t0: float                       # perf_counter at the window's start
    t1: float                       # and at its end
    attempted: int                  # calls or requests sent in the window
    failed: int                     # of those, ones that raised
    completed: int                  # units done in the window
    unit: str                       # what ``completed`` counts
    calls: int                      # engine calls (offline) in the window
    batches: float = 0.0            # server batches completed (serve)
    latencies_s: list = dataclasses.field(default_factory=list)
    done_at: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def by_second(self, per: int) -> list[int]:
        """Units completed in each whole second of the window (``per``
        units a completion)."""
        n = [0] * max(int(self.seconds), 1)
        for t in self.done_at:
            i = int(t - self.t0)
            if i < len(n):
                n[i] += per
        return n
