"""Baseline partitioning strategies (paper §7.4.1); port of
``repro/core/baselines.py``.

1. post-neuron round-robin: whole fan-ins assigned to SPUs round-robin;
   no neuron-state duplication, but imbalanced synaptic load.
2. synapse round-robin: individual synapses round-robin; balanced, but
   post-neuron state duplicated across (almost) all SPUs.
3. weight round-robin: clusters of same-valued weights round-robin;
   maximal weight reuse, poor balance and heavy post duplication.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.memory_model import HardwareConfig, scores_from_assignment


def _result(g: SNNGraph, hw: HardwareConfig, assign: np.ndarray
            ) -> PartitionResult:
    scores = scores_from_assignment(g.weight, g.post, assign, hw)
    return PartitionResult(assign.astype(np.int32), scores,
                           bool(scores.min() >= 0), 0, 0, [])


def post_neuron_round_robin(g: SNNGraph, hw: HardwareConfig
                            ) -> PartitionResult:
    posts = np.unique(g.post)
    spu_of_post = {int(q): i % hw.n_spus for i, q in enumerate(posts)}
    assign = np.array([spu_of_post[int(q)] for q in g.post], np.int32)
    return _result(g, hw, assign)


def synapse_round_robin(g: SNNGraph, hw: HardwareConfig) -> PartitionResult:
    assign = np.arange(g.n_synapses, dtype=np.int32) % hw.n_spus
    return _result(g, hw, assign)


def weight_round_robin(g: SNNGraph, hw: HardwareConfig) -> PartitionResult:
    vals = np.unique(g.weight)
    spu_of_w = {int(v): i % hw.n_spus for i, v in enumerate(vals)}
    assign = np.array([spu_of_w[int(v)] for v in g.weight], np.int32)
    return _result(g, hw, assign)


BASELINES = {
    "post_neuron_rr": post_neuron_round_robin,
    "synapse_rr": synapse_round_robin,
    "weight_rr": weight_round_robin,
}
