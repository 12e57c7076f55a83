"""SNN-as-graph representation (paper Eq. (6)); port of ``repro/core/graph.py``.

Neurons are globally indexed: [0, n_inputs) are input neurons,
[n_inputs, n_neurons) internal neurons whose local index is
``global - n_inputs``. Synapses are flat (pre, post, weight) arrays over
the nonzero connections only. :func:`from_quantized` flattens a
layered quantized SNN into the graph; :func:`random_graph` draws a
random irregular one with the reference's generator calls in the
reference's order, so a seed gives the same graph in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.snn.lif import LIFIntParams
from repro_torch.snn.quantize import QuantizedSNN


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


def from_quantized(qsnn: QuantizedSNN) -> SNNGraph:
    """Flatten a layered quantized SNN into the global graph."""
    sizes = qsnn.layer_sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    pres, posts, ws = [], [], []
    for i, w in enumerate(qsnn.weights):
        r, c = np.nonzero(w)
        pres.append(r + offsets[i])
        posts.append(c + offsets[i + 1])
        ws.append(w[r, c])
    for i, wr in enumerate(qsnn.rec_weights):
        if wr is None:
            continue
        r, c = np.nonzero(wr)
        pres.append(r + offsets[i + 1])
        posts.append(c + offsets[i + 1])
        ws.append(wr[r, c])
    g = SNNGraph(
        n_inputs=sizes[0], n_neurons=int(offsets[-1]),
        pre=np.concatenate(pres).astype(np.int32),
        post=np.concatenate(posts).astype(np.int32),
        weight=np.concatenate(ws).astype(np.int32),
        lif=qsnn.lif,
        output_slice=(int(offsets[-2]), int(offsets[-1])))
    g.validate()
    return g


def random_graph(n_inputs: int, n_internal: int, n_synapses: int,
                 seed: int = 0, weight_lo: int = -7, weight_hi: int = 7,
                 lif: LIFIntParams | None = None) -> SNNGraph:
    """Random irregular graph (property tests, paper Fig. 2b style).

    Draws unique (pre, post) pairs with internal posts, then nonzero
    weights in ``[weight_lo, weight_hi]``, redrawing zeros: the
    reference's generator calls in its order.
    """
    rng = np.random.default_rng(seed)
    n = n_inputs + n_internal
    max_e = n * n_internal
    n_synapses = min(n_synapses, max_e)
    flat = rng.choice(max_e, size=n_synapses, replace=False)
    pre = (flat // n_internal).astype(np.int32)
    post = (flat % n_internal + n_inputs).astype(np.int32)
    w = np.zeros(n_synapses, np.int32)
    while (w == 0).any():  # nonzero weights only
        m = w == 0
        w[m] = rng.integers(weight_lo, weight_hi + 1, m.sum())
    g = SNNGraph(n_inputs, n, pre, post, w,
                 lif or LIFIntParams(leak_shift=2, v_threshold=15, v_reset=0),
                 output_slice=(n - min(4, n_internal), n))
    g.validate()
    return g
