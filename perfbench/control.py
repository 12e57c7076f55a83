"""The control of the comparison: the plain reference put in the
program's place, its membrane potentials held in the nearest integer
register below the width the configuration states
(``control_potential_bits``: 8 bits for the SHD net's 12, 4 for the
MNIST net's 5), wrapping. A later change that narrowed the engine's
state so would be caught: the comparison has to call this run not
correct. The benchmark's own runs never use it; ``readings.py`` and the
tests do."""
from __future__ import annotations

import numpy as np

from perfbench import spec


class ReferenceProgram:
    """Duck-types what the drivers call of a ``Program``."""
    default_engine = "torch"

    def __init__(self, ref, net, potential_bits: int | None):
        self.ref, self.net, self.bits = ref, net, potential_bits

    def precompile(self, *args, **kwargs) -> list:
        return []

    def run(self, ext, spec=None):
        ext = np.asarray(ext)
        squeeze = ext.ndim == 2
        if squeeze:
            ext = ext[None]
        n = self.net
        s, v, p = self.ref.run(n.weights, n.rec_weights, n.leak_shift,
                               n.v_threshold, n.v_reset, ext, self.bits)
        s, v = s.astype(np.int32), v.astype(np.int32)
        if squeeze:
            s, v, p = s[0], v[0], p[0]
        return s, v, {"packet_counts": p}


def substitute(root):
    """``run_cell``'s ``substitute`` for the control."""
    def make(program, net, cfg):
        return ReferenceProgram(spec.reference(root, cfg["reference"]), net,
                                cfg["control_potential_bits"])
    return make
