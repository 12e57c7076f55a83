"""Hardware parameters; port of ``HardwareConfig`` from
``repro/core/memory_model.py``.

Same fields, same defaults, same ``__post_init__`` checks (raised as
``ValueError``). ``Program.load`` builds it from the artifact header.
``tree_depth`` feeds the cycle model; the memory model itself
(Eqs. 9-11) and the multi-chip mesh properties wait for the compiler
slice.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Per-design hardware parameters (paper Table 2 'Hardware' block)."""
    n_spus: int = 16                 # M (power of two; tree fabric)
    unified_mem_depth: int = 128     # L   (memory lines per SPU)
    concentration: int = 3           # K   (weights packed per line)
    weight_bits: int = 4             # W_W
    potential_bits: int = 5
    max_neurons: int = 910           # N   (addressing capacity)
    max_post_neurons: int = 126      # N_p (Neuron State SRAM depth)
    clock_mhz: float = 100.0
    n_chips: int = 1
    inter_chip_hop_cycles: int = 8   # per inter-chip mesh hop of a packet
    mesh_x: int = 0                  # 0, 0 = auto near-square mesh
    mesh_y: int = 0

    def __post_init__(self):
        if not (self.n_spus >= 2 and (self.n_spus & (self.n_spus - 1)) == 0):
            raise ValueError("MC/ME trees require a power-of-two SPU count")
        if not (self.n_chips >= 1
                and (self.n_chips & (self.n_chips - 1)) == 0):
            raise ValueError("n_chips must be a power of two (chip fabric "
                             "mirrors the tree)")
        if not (self.n_spus % self.n_chips == 0
                and self.n_spus // self.n_chips >= 2):
            raise ValueError("each chip needs its own power-of-two MC/ME "
                             "subtree (>= 2 SPUs)")
        if (self.mesh_x == 0) != (self.mesh_y == 0):
            raise ValueError("give both mesh dims or neither (0, 0 = auto "
                             "near-square)")
        if self.mesh_x and self.mesh_x * self.mesh_y != self.n_chips:
            raise ValueError(f"mesh {self.mesh_x}x{self.mesh_y} != "
                             f"n_chips={self.n_chips}")

    @property
    def tree_depth(self) -> int:
        return int(math.log2(self.n_spus))
