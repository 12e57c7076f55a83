"""Probabilistic partitioning (paper §6.2) — compatibility shim; port of
``repro/core/partition.py``.

The implementation moved to the :mod:`repro_torch.core.mapping` package
(DESIGN.md §6): ``mapping.books`` owns the flat occupancy bookkeeping,
``mapping.tree`` the partitioning-tree geometry, ``mapping.search`` the
vectorized restart population and the portfolio search, and
``mapping.strategies`` the registry behind ``compile(method=...)``.

:func:`partition` keeps the original single-seed entry point. For a
fixed (graph, hw, seed) it is BIT-IDENTICAL to the preserved reference
loop ``mapping.legacy.partition_legacy`` (``tests/test_torch_mapping.py``
holds assignment/scores/iterations/history to both packages' loops).
Note one recorded deviation vs the pre-refactor loop (DESIGN.md §8
"membership order"): per-SPU membership is iterated in
synapse-index order instead of CPython-set hash order, so same-seed
assignments are a different — equally distributed — draw than the seed
repo produced; mappings persisted in Program artifacts are unaffected.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult  # noqa: F401 (re-export)
from repro_torch.core.mapping.search import framework_partition
from repro_torch.core.memory_model import HardwareConfig


def partition(g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
              max_iters: int = 50000, eta: float = 0.25,
              move_mode: str = "decisive",
              stagnation_window: int = 300, cooldown: int = 64,
              scan_cap: int = 384,
              ) -> PartitionResult:
    """Single-seed probabilistic partition (paper §6.2).

    Thin wrapper over the vectorized search with one restart; all the
    original knobs pass straight through.
    """
    winner, _, _ = framework_partition(
        g, hw, seed=seed, restarts=1, max_iters=max_iters, eta=eta,
        move_mode=move_mode, stagnation_window=stagnation_window,
        cooldown=cooldown, scan_cap=scan_cap)
    winner.assign = np.ascontiguousarray(winner.assign)
    return winner
