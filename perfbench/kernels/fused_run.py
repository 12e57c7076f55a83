"""Frozen work of one ``fused_run`` launch: a whole T-step run of the
configuration's network over B trains, counted from the shapes, not from
the program's tensors, so it counts the same work whatever implements
it.

* operations: each non-zero synapse multiplies and adds once a step and
  train, ``2 * synapses * T * B``;
* bytes: each input read once and each output written once. The spike
  trains in and out count 1 byte an element (they are binary), the final
  potentials and the packet counts 4, and the weight plane
  ``ceil(weight_bits / 8)`` bytes a weight over ``n_pre * n_post``
  (every neuron a pre, every internal neuron a post).
"""
from __future__ import annotations

import math

NAME_MATCH = "fused_run"          # the device kernel's name contains this


def operations(net: dict, batch: int) -> int:
    return 2 * net["synapses"] * net["timesteps"] * batch


def bytes_moved(net: dict, batch: int) -> int:
    t, n_in, n_int = net["timesteps"], net["n_inputs"], net["n_internal"]
    plane = (n_in + n_int) * n_int * math.ceil(net["weight_bits"] / 8)
    return (t * batch * n_in          # ext, binary
            + t * batch * n_int       # spikes, binary
            + batch * n_int * 4       # v_final, int32
            + t * batch * 4           # packet counts, int32
            + plane)
