"""The portfolio search's trace; port of ``CandidateTrace`` and
``SearchTrace`` from ``repro/core/mapping/search.py``, so the header of
a portfolio-compiled artifact round-trips. The search itself waits for
the compiler slice (ROADMAP Queue A item 7)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CandidateTrace:
    """One candidate mapping tried by the portfolio search."""
    strategy: str                 # "framework" or a baseline name
    seed: int | None              # restart seed (None for baselines)
    feasible: bool
    min_score: int                # worst-SPU Eq. (10) score
    iterations: int
    seconds: float
    ot_depth: int | None = None   # best strategy's depth (feasible only)
    memory_kb: float | None = None        # Eq. (11) at this OT depth
    memory_lines: int | None = None       # total UM lines the mapping uses
    selected: bool = False
    # joint co-optimization (§6.3): the best ScheduleStrategy for this
    # mapping, and the OT depth under every registered strategy
    schedule_method: str | None = None
    schedule_depths: dict | None = None


@dataclasses.dataclass
class SearchTrace:
    """Per-candidate record of one portfolio search."""
    candidates: list[CandidateTrace]
    seconds: float
    budget_exhausted: bool = False

    @property
    def n_feasible(self) -> int:
        return sum(c.feasible for c in self.candidates)

    @property
    def selected(self) -> CandidateTrace:
        return next(c for c in self.candidates if c.selected)

    def to_json(self) -> dict:
        return {"seconds": self.seconds,
                "budget_exhausted": self.budget_exhausted,
                "candidates": [dataclasses.asdict(c)
                               for c in self.candidates]}

    @classmethod
    def from_json(cls, d: dict) -> "SearchTrace":
        return cls(candidates=[CandidateTrace(**c)
                               for c in d.get("candidates", [])],
                   seconds=float(d.get("seconds", 0.0)),
                   budget_exhausted=bool(d.get("budget_exhausted", False)))
