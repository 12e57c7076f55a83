"""SNN-as-graph representation (paper Eq. (6)); port of ``repro/core/graph.py``.

Neurons are globally indexed: [0, n_inputs) are input neurons,
[n_inputs, n_neurons) internal neurons whose local index is
``global - n_inputs``. Synapses are flat (pre, post, weight) arrays over
the nonzero connections only. ``from_quantized`` and ``random_graph``
wait for the compiler slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.snn.lif import LIFIntParams


@dataclasses.dataclass
class SNNGraph:
    n_inputs: int
    n_neurons: int             # inputs + internal
    pre: np.ndarray            # [E] int32 global pre index
    post: np.ndarray           # [E] int32 global post index (always internal)
    weight: np.ndarray         # [E] int32 quantized weight (nonzero)
    lif: LIFIntParams
    output_slice: tuple[int, int] = (0, 0)   # global [start, stop) of outputs

    def __post_init__(self):
        if not self.pre.shape == self.post.shape == self.weight.shape:
            raise ValueError("pre/post/weight shapes differ")
        if not (self.weight != 0).all():
            raise ValueError("zero-weight synapses must be dropped")
        if not (self.post >= self.n_inputs).all():
            raise ValueError("post-synaptic neurons must be internal")

    @property
    def n_internal(self) -> int:
        return self.n_neurons - self.n_inputs

    @property
    def n_synapses(self) -> int:
        return int(self.pre.shape[0])

    def local(self, global_idx: np.ndarray) -> np.ndarray:
        return global_idx - self.n_inputs

    def validate(self):
        if not ((self.pre >= 0).all() and (self.pre < self.n_neurons).all()):
            raise ValueError("pre index out of range")
        if not ((self.post >= self.n_inputs).all()
                and (self.post < self.n_neurons).all()):
            raise ValueError("post index out of range")
        key = self.pre.astype(np.int64) * self.n_neurons + self.post
        if len(np.unique(key)) != len(key):
            raise ValueError("duplicate synapses")
