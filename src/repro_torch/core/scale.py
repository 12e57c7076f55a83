"""Synthetic large-graph generator for compiler-scale benchmarking (§11);
port of ``repro/core/scale.py``, the same numpy streams.

``random_graph`` samples uniform (pre, post) pairs — fine for property
tests, but real SNN workloads are LAYERED (feedforward chains with
optional recurrence) and have SKEWED fan-out (a few hub neurons drive
many posts — exactly what stresses hyperedge-aware mapping). This
module builds such graphs at the ROADMAP's 10⁵–10⁶-synapse scale,
fully vectorized, plus a matching multi-chip
:class:`~repro_torch.core.memory_model.HardwareConfig`.

Determinism: a (shape, seed) pair always yields the same graph — the
benchmark pins one and tracks compile seconds / peak RSS against it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.snn.lif import LIFIntParams

TOPOLOGIES = ("layered", "recurrent", "mixed")


def _skewed_sources(rng: np.random.Generator, n_pre: int, count: int,
                    skew: float) -> np.ndarray:
    """Draw ``count`` pre indices with Zipf-like fan-out skew.

    ``skew=0`` is uniform; larger values concentrate fan-out on hub
    neurons (pre i drawn with probability ∝ (i+1)^-skew after a seeded
    shuffle, so the hubs are spread across the layer, not its head).
    """
    if skew <= 0:
        return rng.integers(0, n_pre, count, dtype=np.int64)
    p = (np.arange(1, n_pre + 1, dtype=np.float64)) ** (-skew)
    p /= p.sum()
    perm = rng.permutation(n_pre)
    return perm[rng.choice(n_pre, size=count, p=p)]


def _unique_pairs(rng: np.random.Generator, n_pre: int, n_post: int,
                  count: int, skew: float, pre_base: int, post_base: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``count`` distinct (pre, post) pairs inside one block,
    skewed over pres; oversample + dedup + top-up until exact."""
    count = min(count, n_pre * n_post)
    keys = np.empty(0, np.int64)
    want = count
    while want > 0:
        pre = _skewed_sources(rng, n_pre, int(want * 1.3) + 8, skew)
        post = rng.integers(0, n_post, len(pre), dtype=np.int64)
        keys = np.unique(np.r_[keys, pre * n_post + post])[:count]
        want = count - len(keys)
    keys = keys[rng.permutation(len(keys))]
    return pre_base + keys // n_post, post_base + keys % n_post


def synthetic_graph(n_synapses: int, *, topology: str = "layered",
                    n_layers: int = 4, neurons_per_synapse: float = 0.02,
                    skew: float = 1.0, recurrent_frac: float = 0.25,
                    seed: int = 0, weight_lo: int = -31, weight_hi: int = 31,
                    lif: LIFIntParams | None = None) -> SNNGraph:
    """Build a layered / recurrent synthetic SNN with ``n_synapses``
    connections (exact) and controllable fan-out skew.

    * ``layered`` — an ``n_layers``-deep feedforward chain; layer sizes
      split ``n_synapses * neurons_per_synapse`` neurons evenly.
    * ``recurrent`` — one input layer plus a single recurrent pool.
    * ``mixed`` — the layered chain with ``recurrent_frac`` of each
      hidden layer's synapse budget rewired within the layer (SRNN
      style, like the paper's SHD network).
    """
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}")
    rng = np.random.default_rng(seed)
    n_neurons = max(int(n_synapses * neurons_per_synapse), 8 * n_layers)
    if topology == "recurrent":
        n_layers = 2
    layer = np.full(n_layers, n_neurons // n_layers, np.int64)
    layer[:n_neurons % n_layers] += 1
    offs = np.r_[0, np.cumsum(layer)]
    n_inputs = int(layer[0])

    # synapse budget per feedforward hop, proportional to the fan-in side
    hop_w = layer[1:].astype(np.float64)
    budget = np.floor(n_synapses * hop_w / hop_w.sum()).astype(np.int64)
    budget[0] += n_synapses - budget.sum()

    pres, posts = [], []
    for h in range(n_layers - 1):
        ff = int(budget[h])
        rec = 0
        if topology == "recurrent" or \
                (topology == "mixed" and h + 1 < n_layers - 1):
            rec = int(ff * recurrent_frac)
            ff -= rec
        p, q = _unique_pairs(rng, int(layer[h]), int(layer[h + 1]), ff,
                             skew, int(offs[h]), int(offs[h + 1]))
        pres.append(p)
        posts.append(q)
        if rec:
            p, q = _unique_pairs(rng, int(layer[h + 1]), int(layer[h + 1]),
                                 rec, skew, int(offs[h + 1]),
                                 int(offs[h + 1]))
            pres.append(p)
            posts.append(q)
    pre = np.concatenate(pres).astype(np.int32)
    post = np.concatenate(posts).astype(np.int32)

    w = np.zeros(len(pre), np.int32)
    while (w == 0).any():
        m = w == 0
        w[m] = rng.integers(weight_lo, weight_hi + 1, m.sum())
    g = SNNGraph(n_inputs, int(offs[-1]), pre, post, w,
                 lif or LIFIntParams(leak_shift=2, v_threshold=15,
                                     v_reset=0),
                 output_slice=(int(offs[-2]), int(offs[-1])))
    g.validate()
    return g


def scale_hw(g: SNNGraph, *, n_chips: int = 1, spus_per_chip: int = 16,
             concentration: int = 3, weight_bits: int = 6,
             headroom: float = 1.3, mesh_x: int = 0,
             mesh_y: int = 0) -> HardwareConfig:
    """A feasibility-plausible HardwareConfig for a synthetic graph: the
    Eq. (9) depth is the balanced per-SPU usage estimate × headroom.

    ``mesh_x``/``mesh_y`` pin the 2D inter-chip mesh (DESIGN.md §12);
    the (0, 0) default keeps the near-square auto factorization.
    """
    m = n_chips * spus_per_chip
    nw = len(np.unique(g.weight))
    per_spu = (-(-g.n_internal // m) + -(-(nw + 1) // concentration))
    return HardwareConfig(
        n_spus=m, unified_mem_depth=int(np.ceil(per_spu * headroom)),
        concentration=concentration, weight_bits=weight_bits,
        potential_bits=18, max_neurons=g.n_neurons,
        max_post_neurons=g.n_internal, n_chips=n_chips,
        mesh_x=mesh_x, mesh_y=mesh_y)
