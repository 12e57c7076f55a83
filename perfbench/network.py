"""The configuration's integer network, drawn from the seed.

Trained weights would need the real data sets and minutes of training,
so seeded integer weights at the published widths, sparsity and weight
bits stand in. Each weight matrix gets exactly ``round(fan_in * fan_out
* (1 - sparsity))`` non-zero synapses at uniformly drawn places (a
recurrent matrix has no self-loops), so every seed has the same number
of synapses and the same work; their values are a normal of standard
deviation ``qmax * weight_std_of_qmax`` rounded, clipped to the signed
``weight_bits`` range, and redrawn where 0. The LIF constants (leak
shift from alpha, threshold, reset) are the configuration's own.

The draw is NumPy on the host: the network is 0.3 MB of integers that
the compiler, a host pass, reads first; the benchmark hands the same
arrays to the program (as a ``QuantizedSNN``) and to the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Network:
    layer_sizes: tuple[int, ...]
    weights: list              # int32 [fan_in, fan_out] per layer
    rec_weights: list          # int32 [n, n] per hidden layer, or None
    leak_shift: int
    v_threshold: int
    v_reset: int

    @property
    def n_synapses(self) -> int:
        return sum(int(np.count_nonzero(w)) for w in
                   self.weights + [r for r in self.rec_weights
                                   if r is not None])


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one use of ``seed``; any whole number is taken."""
    return np.random.default_rng([seed % (1 << 64), *tags])


def nonzero_count(fan_in: int, fan_out: int, sparsity: float) -> int:
    return int(round(fan_in * fan_out * (1.0 - sparsity)))


def _matrix(rng: np.random.Generator, fan_in: int, fan_out: int,
            sparsity: float, bits: int, std_of_qmax: float,
            no_diagonal: bool) -> np.ndarray:
    qmax = 2 ** (bits - 1) - 1
    places = np.arange(fan_in * fan_out)
    if no_diagonal:
        places = places[places // fan_out != places % fan_out]
    k = nonzero_count(fan_in, fan_out, sparsity)
    chosen = rng.choice(places, size=k, replace=False)
    vals = np.zeros(k, np.int64)
    todo = np.ones(k, bool)
    while todo.any():
        draw = np.rint(rng.normal(0.0, qmax * std_of_qmax, int(todo.sum())))
        vals[todo] = np.clip(draw, -qmax - 1, qmax)
        todo = vals == 0
    w = np.zeros(fan_in * fan_out, np.int32)
    w[chosen] = vals
    return w.reshape(fan_in, fan_out)


def draw_network(cfg: dict, seed: int) -> Network:
    sizes = tuple(cfg["layer_sizes"])
    rng = rng_for(seed, 1)
    bits, std = cfg["weight_bits"], cfg["assumed"]["weight_std_of_qmax"]
    ws, wrs = [], []
    for i in range(len(sizes) - 1):
        ws.append(_matrix(rng, sizes[i], sizes[i + 1], cfg["sparsity"],
                          bits, std, False))
        hidden = i < len(sizes) - 2
        wrs.append(_matrix(rng, sizes[i + 1], sizes[i + 1],
                           cfg["sparsity"], bits, std, True)
                   if cfg["recurrent"] and hidden else None)
    a = cfg["assumed"]
    return Network(sizes, ws, wrs, a["leak_shift"], a["v_threshold"],
                   a["v_reset"])


def expected_synapses(cfg: dict) -> int:
    """The synapse count every seed draws, from the sizes alone."""
    sizes = cfg["layer_sizes"]
    n = 0
    for i in range(len(sizes) - 1):
        n += nonzero_count(sizes[i], sizes[i + 1], cfg["sparsity"])
        if cfg["recurrent"] and i < len(sizes) - 2:
            n += nonzero_count(sizes[i + 1], sizes[i + 1], cfg["sparsity"])
    return n


def to_program_input(net: Network):
    """The network as the port's ``QuantizedSNN``, which
    ``repro_torch.core.compile`` takes."""
    from repro_torch.snn.lif import LIFIntParams
    from repro_torch.snn.quantize import QuantizedSNN
    lif = LIFIntParams(leak_shift=net.leak_shift,
                       v_threshold=net.v_threshold, v_reset=net.v_reset)
    return QuantizedSNN(net.layer_sizes, [w.copy() for w in net.weights],
                        [None if r is None else r.copy()
                         for r in net.rec_weights], 1.0, lif,
                        any(r is not None for r in net.rec_weights))
