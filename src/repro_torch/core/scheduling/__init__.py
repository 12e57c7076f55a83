"""Port of :mod:`repro.core.scheduling` (paper §6.3), numpy only.

#   tables      OpTables / LoweredProgram containers + lower_tables
#   vectorized  the array-core scheduler
#   legacy      the original Python loop, kept as the parity reference
#   strategies  the ScheduleStrategy registry
#   validate    schedule legality checks

:func:`schedule` resolves the strategy name to a send order and runs
the vectorized core; its tables are the reference's bit for bit, and
:func:`~repro_torch.core.scheduling.legacy.schedule_legacy`'s.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling.legacy import schedule_legacy
from repro_torch.core.scheduling.strategies import (SCHEDULE_STRATEGIES,
                                                    ConsecutiveStrategy,
                                                    LoadBalanceStrategy,
                                                    ScheduleStrategy,
                                                    SlackStrategy,
                                                    get_schedule_strategy,
                                                    register_schedule_strategy)
from repro_torch.core.scheduling.tables import (NOP, LoweredProgram,
                                                OpTables, lower_tables)
from repro_torch.core.scheduling.validate import validate_schedule
from repro_torch.core.scheduling.vectorized import (GroupInfo, group_info,
                                                    schedule_vectorized)


def schedule(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig, *,
             method: str = "slack",
             info: GroupInfo | None = None) -> OpTables:
    """Heuristic scheduling (paper §6.3) of an assignment into OpTables.

    ``method`` names a registered :class:`ScheduleStrategy` (the post
    transmit-order policy); ``'slack'`` is the default. ``info`` takes a
    precomputed :func:`group_info` so multi-strategy callers group only
    once.
    """
    strategy = get_schedule_strategy(method)
    gi = info if info is not None else group_info(g, assign)
    return schedule_vectorized(g, assign, hw,
                               send_order=strategy.send_order(gi), info=gi)


__all__ = [
    "NOP", "OpTables", "LoweredProgram", "lower_tables",
    "schedule", "schedule_legacy", "schedule_vectorized",
    "GroupInfo", "group_info", "validate_schedule",
    "ScheduleStrategy", "SlackStrategy", "ConsecutiveStrategy",
    "LoadBalanceStrategy", "SCHEDULE_STRATEGIES",
    "get_schedule_strategy", "register_schedule_strategy",
]
