"""Pluggable mapping-strategy registry; port of
``repro/core/mapping/strategies.py``.

``partition_pass`` used to special-case ``method`` strings ("framework"
vs keys of ``baselines.BASELINES``). Every way of producing a synapse ->
SPU assignment now implements one protocol and lives in one registry;
the pass just resolves the name. Registering a new strategy (an ILP
mapper, a hardware-vendor heuristic, a learned policy) is one
``register_strategy`` call — no compiler changes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.search import framework_partition
from repro_torch.core.memory_model import HardwareConfig


@runtime_checkable
class MappingStrategy(Protocol):
    """One way of producing a synapse -> SPU assignment."""

    name: str

    def partition(self, g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                  max_iters: int = 20000, restarts: int = 1,
                  workers: int = 1) -> PartitionResult:
        ...


@dataclasses.dataclass(frozen=True)
class FrameworkStrategy:
    """The paper's probabilistic search (§6.2), vectorized population."""

    name: str = "framework"

    def partition(self, g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                  max_iters: int = 20000, restarts: int = 1,
                  workers: int = 1) -> PartitionResult:
        winner, _, _ = framework_partition(g, hw, seed=seed,
                                           max_iters=max_iters,
                                           restarts=restarts)
        return winner


@dataclasses.dataclass(frozen=True)
class HypergraphStrategy:
    """Greedy hyperedge-overlap mapping + FM refinement (DESIGN.md §11);
    deterministic, so seed/iters/restarts are ignored."""

    name: str = "hypergraph"

    def partition(self, g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                  max_iters: int = 20000, restarts: int = 1,
                  workers: int = 1) -> PartitionResult:
        from repro_torch.core.mapping.hypergraph import hypergraph_partition
        return hypergraph_partition(g, hw, seed=seed)


@dataclasses.dataclass(frozen=True)
class MultilevelStrategy:
    """Coarsen–partition–refine for compiler-scale graphs (DESIGN.md §11)."""

    name: str = "multilevel"

    def partition(self, g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                  max_iters: int = 20000, restarts: int = 1,
                  workers: int = 1) -> PartitionResult:
        from repro_torch.core.mapping.multilevel import multilevel_partition
        return multilevel_partition(g, hw, seed=seed, max_iters=max_iters,
                                    restarts=restarts, workers=workers)


@dataclasses.dataclass(frozen=True)
class BaselineStrategy:
    """A deterministic baseline (paper §7.4.1); seed/iters are ignored."""

    name: str
    fn: Callable[[SNNGraph, HardwareConfig], PartitionResult]

    def partition(self, g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                  max_iters: int = 20000, restarts: int = 1,
                  workers: int = 1) -> PartitionResult:
        return self.fn(g, hw)


STRATEGIES: dict[str, MappingStrategy] = {}


def register_strategy(strategy: MappingStrategy, *,
                      replace: bool = False) -> MappingStrategy:
    """Add a strategy to the registry (its ``name`` is the compile
    ``method=`` key). Re-registering a taken name requires
    ``replace=True``."""
    if not replace and strategy.name in STRATEGIES:
        raise ValueError(f"mapping strategy {strategy.name!r} already "
                         f"registered; pass replace=True to override")
    STRATEGIES[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> MappingStrategy:
    """Resolve a ``method=`` name; unknown names list what exists."""
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; "
                         f"use one of {sorted(STRATEGIES)}") from None


def _register_builtins() -> None:
    from repro_torch.core.baselines import BASELINES
    register_strategy(FrameworkStrategy(), replace=True)
    register_strategy(HypergraphStrategy(), replace=True)
    register_strategy(MultilevelStrategy(), replace=True)
    for name, fn in BASELINES.items():
        register_strategy(BaselineStrategy(name, fn), replace=True)


_register_builtins()
