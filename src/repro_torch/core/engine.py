"""Run statistics; port of ``packet_stats`` from ``repro/core/engine.py``.

The python and oracle executors and ``CycleModel`` wait for a later
slice (ROADMAP Queue A item 3).
"""
from __future__ import annotations

import numpy as np


def packet_stats(pkt_counts: np.ndarray) -> dict:
    """Per-run stats dict shared by every executor."""
    return {"packet_counts": pkt_counts,
            "mean_packets_per_step": float(pkt_counts.mean())}
