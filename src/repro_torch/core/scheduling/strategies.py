"""The schedule-strategy registry; port of
``repro/core/scheduling/strategies.py``.

A :class:`ScheduleStrategy` chooses the post-neuron *transmit order* of
§6.3; the send-slot recurrence, the pinning and the backward fill are
order-independent, so a strategy is exactly one policy decision: which
posts send early and which send late. ``register_schedule_strategy``
adds custom orderings without changes to the scheduler.

Built-ins:

* ``slack``: ascending max-synapses-on-any-single-SPU, so high-fan-in
  posts transmit last and backward-fill slack is maximized (the
  default);
* ``consecutive``: the paper's baseline, posts in natural index order;
* ``load_balance``: ascending TOTAL fan-in (ties by per-SPU max, then
  index): posts spread across many SPUs transmit late.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.scheduling.vectorized import GroupInfo, slack_send_order


@runtime_checkable
class ScheduleStrategy(Protocol):
    """One policy for ordering post-neuron transmissions."""

    name: str

    def send_order(self, info: GroupInfo) -> np.ndarray:
        """Return the posts of ``info`` as a send-order permutation."""
        ...


@dataclasses.dataclass(frozen=True)
class SlackStrategy:
    """Ascending (max synapses per SPU, post) — maximizes fill slack."""

    name: str = "slack"

    def send_order(self, info: GroupInfo) -> np.ndarray:
        return slack_send_order(info)


@dataclasses.dataclass(frozen=True)
class ConsecutiveStrategy:
    """The paper's consecutive-slot baseline: natural post order."""

    name: str = "consecutive"

    def send_order(self, info: GroupInfo) -> np.ndarray:
        return info.posts.copy()


@dataclasses.dataclass(frozen=True)
class LoadBalanceStrategy:
    """Ascending (total fan-in, max per SPU, post) — spread posts late."""

    name: str = "load_balance"

    def send_order(self, info: GroupInfo) -> np.ndarray:
        return info.posts[np.lexsort((info.posts, info.cmax, info.total))]


SCHEDULE_STRATEGIES: dict[str, ScheduleStrategy] = {}


def register_schedule_strategy(strategy: ScheduleStrategy, *,
                               replace: bool = False) -> ScheduleStrategy:
    """Add a strategy to the registry (its ``name`` is the compile
    ``schedule_method=`` key). Re-registering a taken name requires
    ``replace=True``."""
    if not replace and strategy.name in SCHEDULE_STRATEGIES:
        raise ValueError(f"schedule strategy {strategy.name!r} already "
                         f"registered; pass replace=True to override")
    SCHEDULE_STRATEGIES[strategy.name] = strategy
    return strategy


def get_schedule_strategy(name: str) -> ScheduleStrategy:
    """Resolve a ``schedule_method=`` name; unknown names list what
    exists."""
    try:
        return SCHEDULE_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule_method {name!r}; "
            f"use one of {sorted(SCHEDULE_STRATEGIES)}") from None


def _register_builtins() -> None:
    # "slack" first: the portfolio's joint selection iterates the
    # registry in insertion order with a strict depth comparison, so the
    # default strategy wins per-candidate ties
    register_schedule_strategy(SlackStrategy(), replace=True)
    register_schedule_strategy(ConsecutiveStrategy(), replace=True)
    register_schedule_strategy(LoadBalanceStrategy(), replace=True)


_register_builtins()
