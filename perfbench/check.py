"""What decides ``correct``: the outputs of the timed path held against
the plain reference's, element for element. The engine is integer and
deterministic, so each number compared is a count of elements that
differ, and its limit is 0. ``missing`` counts the answers due in the
window that never came (a request that raised)."""
from __future__ import annotations

import numpy as np

# sound runs read 0 on every seed, the control millions of spikes off
# (PERF.md section 2): an exact comparison has the limit 0
LIMITS = {"spikes_off": 0, "v_off": 0, "packets_off": 0, "missing": 0}


def expected(ref, net, pool: np.ndarray, potential_bits=None,
             block: int = 64) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's outputs for every pool entry, in blocks of rows."""
    parts = [ref.run(net.weights, net.rec_weights, net.leak_shift,
                     net.v_threshold, net.v_reset, pool[i:i + block],
                     potential_bits)
             for i in range(0, len(pool), block)]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def _off(got, want) -> int:
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


class Tally:
    def __init__(self):
        self.counts = {k: 0 for k in LIMITS}
        self.rows = 0

    def add(self, exp, idx, spikes, v, pkts) -> None:
        """Rows ``idx`` of the pool against ``(spikes, v, pkts)``."""
        s, vv, p = exp
        self.counts["spikes_off"] += _off(spikes, s[idx])
        self.counts["v_off"] += _off(v, vv[idx])
        self.counts["packets_off"] += _off(pkts, p[idx])
        self.rows += int(np.size(idx))

    def checks(self) -> dict:
        return {k: {"value": v, "limit": LIMITS[k]}
                for k, v in self.counts.items()}

    def correct(self) -> bool:
        return all(v <= LIMITS[k] for k, v in self.counts.items())
