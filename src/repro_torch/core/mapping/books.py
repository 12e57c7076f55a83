"""The partition's result; port of ``PartitionResult`` from
``repro/core/mapping/books.py``. The search's occupancy bookkeeping
(``Books``) waits for the compiler slice (ROADMAP Queue A item 7)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PartitionResult:
    assign: np.ndarray          # [E] synapse -> SPU
    scores: np.ndarray          # [M] final Eq. (10) scores
    feasible: bool
    iterations: int
    perturbations: int
    score_history: list         # mean score per iteration
