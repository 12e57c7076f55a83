"""The plain reference: a layered integer LIF network in NumPy, with no
mapping, no schedule and no kernel.

The semantics are the SupraSNN hardware's (paper sec. 4.2): at step t
the first layer takes the external spikes of step t; every other
synapse (a layer's input from the layer below, a recurrent synapse)
carries the spikes its pre neuron fired at step t - 1. Each neuron
then leaks by a right shift, adds its current and fires where it
reaches the threshold, which resets it::

    v = v - (v >> leak_shift) + current
    s = v >= v_threshold;  v[s] = v_reset

One MC packet leaves per spike that is distributed: step t's count is
the external spikes of step t plus every internal spike of step t - 1.

The currents are integer sums computed as float64 products (exact:
every partial sum is an integer far below 2**53), the state in int64
(no int32 wrap occurs at these sizes). ``potential_bits`` holds the
state in a narrower two's-complement register instead, wrapping, which
is the control of the comparison, not the reference.
"""
from __future__ import annotations

import numpy as np


def _wrap(v: np.ndarray, bits: int | None) -> np.ndarray:
    if bits is None:
        return v
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def run(weights, rec_weights, leak_shift: int, v_threshold: int,
        v_reset: int, ext: np.ndarray, potential_bits: int | None = None
        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``ext`` [B, T, n_inputs] -> ``(spikes [B, T, n_internal], v_final
    [B, n_internal], packet_counts [B, T])``, int64, the internal
    neurons in layer order."""
    ext = np.asarray(ext)
    b, t_steps, _ = ext.shape
    ws = [np.asarray(w, np.float64) for w in weights]
    wrs = [None if r is None else np.asarray(r, np.float64)
           for r in rec_weights]
    sizes = [w.shape[1] for w in ws]
    v = [np.zeros((b, n), np.int64) for n in sizes]
    s = [np.zeros((b, n), np.float64) for n in sizes]
    spikes = np.zeros((b, t_steps, sum(sizes)), np.int64)
    pkts = np.zeros((b, t_steps), np.int64)
    x = ext.astype(np.float64)
    for t in range(t_steps):
        pkts[:, t] = np.count_nonzero(ext[:, t], axis=1) + sum(
            si.sum(axis=1).astype(np.int64) for si in s)
        new = []
        for i, w in enumerate(ws):
            cur = (x[:, t] if i == 0 else s[i - 1]) @ w
            if wrs[i] is not None:
                cur = cur + s[i] @ wrs[i]
            vi = v[i] - (v[i] >> leak_shift) + np.rint(cur).astype(np.int64)
            vi = _wrap(vi, potential_bits)
            fired = vi >= v_threshold
            v[i] = np.where(fired, v_reset, vi)
            new.append(fired.astype(np.float64))
        s = new
        spikes[:, t] = np.concatenate(s, axis=1).astype(np.int64)
    return spikes, np.concatenate(v, axis=1), pkts
