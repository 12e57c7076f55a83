"""SupraSNN memory model; port of ``repro/core/memory_model.py``:
the Unified-Memory constraint Eq. (9), the SPU score Eq. (10) and the
total-memory expression Eq. (11), numpy only.

:class:`HardwareConfig` has the reference's fields, defaults and
``__post_init__`` checks (raised as ``ValueError``). A config may
describe ``n_chips`` devices: ``n_spus`` stays the total SPU count and
chip ``i // spus_per_chip`` holds SPU ``i``; the chips sit on a
``mesh_x × mesh_y`` XY-routed grid. The memory expressions become
per-chip structures replicated ``n_chips`` times; with ``n_chips=1``
every number is the single-chip model's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


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

    @property
    def spus_per_chip(self) -> int:
        return self.n_spus // self.n_chips

    @property
    def mesh_dims(self) -> tuple[int, int]:
        """(mesh_x, mesh_y) with the auto near-square default resolved."""
        if self.mesh_x:
            return self.mesh_x, self.mesh_y
        b = int(math.log2(self.n_chips))
        x = 1 << ((b + 1) // 2)
        return x, self.n_chips // x

    def chip_of(self, spu):
        """Chip id of an SPU id (scalar or array)."""
        return spu // self.spus_per_chip

    def chip_coords(self, chip):
        """(col, row) mesh coordinates of a chip id (scalar or array)."""
        x, _ = self.mesh_dims
        return chip % x, chip // x

    def chip_hops(self, a, b):
        """XY-routing hop count between chips ``a`` and ``b`` (Manhattan
        distance on the mesh; scalar or array)."""
        ax, ay = self.chip_coords(a)
        bx, by = self.chip_coords(b)
        return np.abs(ax - bx) + np.abs(ay - by)


def spu_usage(n_unique_weights: int, n_posts: int, k: int) -> int:
    """Memory lines used by one SPU: ceil((|Q|+1)/K) + |P| (LHS of Eq. 9)."""
    return math.ceil((n_unique_weights + 1) / k) + n_posts


def spu_score(n_unique_weights: int, n_posts: int, hw: HardwareConfig) -> int:
    """Eq. (10): L - (ceil((|Q|+1)/K) + |P|). Negative => violation."""
    return hw.unified_mem_depth - spu_usage(n_unique_weights, n_posts,
                                            hw.concentration)


def scores_from_assignment(weights: np.ndarray, posts: np.ndarray,
                           assign: np.ndarray, hw: HardwareConfig
                           ) -> np.ndarray:
    """Per-SPU Eq. (10) scores of a synapse->SPU assignment.

    weights/posts: [E] synapse attributes; assign: [E] SPU ids. The
    values are factorized first, so empty SPUs and an empty graph are
    well-defined.
    """
    m = hw.n_spus
    uq = np.zeros(m, np.int64)
    up = np.zeros(m, np.int64)
    for arr, out in ((weights, uq), (posts, up)):
        vals, inv = np.unique(arr, return_inverse=True)
        if not len(vals):
            continue
        pairs = np.unique(assign.astype(np.int64) * len(vals) + inv)
        np.add.at(out, pairs // len(vals), 1)
    return (hw.unified_mem_depth
            - (-(-(uq + 1) // hw.concentration) + up))


def usage_from_assignment(weights: np.ndarray, posts: np.ndarray,
                          assign: np.ndarray, hw: HardwareConfig
                          ) -> np.ndarray:
    """Per-SPU memory-line usage (LHS of Eq. 9) of an assignment:
    ``unified_mem_depth - scores_from_assignment(...)``."""
    return hw.unified_mem_depth - scores_from_assignment(weights, posts,
                                                         assign, hw)


def _lg(x: int) -> int:
    return math.ceil(math.log2(max(x, 2)))


def total_memory_bits(hw: HardwareConfig, op_table_depth: int) -> int:
    """Eq. (11): routing + M*(OT + UM + Spike Memory) + Neuron State SRAM.

    Every SPU holds an N-bit Spike Memory bitmap, which :func:`bram_count`
    packs as a physical structure, so it counts here too. With
    ``n_chips > 1`` the per-chip structure set (routing over the chip's
    own SPUs, one Neuron Unit; routing and spike bitmaps span the full
    N) is replicated ``n_chips`` times.
    """
    n, np_ = hw.max_neurons, hw.max_post_neurons
    m_chip = hw.spus_per_chip
    s_um, k, ww = hw.unified_mem_depth, hw.concentration, hw.weight_bits
    ot_entry = 2 * _lg(s_um) + _lg(k) + _lg(n) + 2
    routing = n * m_chip
    ot = op_table_depth * ot_entry
    um = k * ww * s_um
    spike = n                                # per-SPU Spike Memory bitmap
    nu = np_ * (_lg(n) + k * ww - _lg(np_) + 1)
    per_chip = routing + m_chip * (ot + um + spike) + nu
    return hw.n_chips * per_chip


def total_memory_kb(hw: HardwareConfig, op_table_depth: int) -> float:
    return total_memory_bits(hw, op_table_depth) / 8 / 1024


def bram_count(hw: HardwareConfig, op_table_depth: int,
               bram_kbits: int = 18) -> float:
    """7-series packing model: each physical memory structure rounds up
    to half-BRAM (18 Kb) granularity, reported in 36 Kb BRAMs; packed
    per chip and summed when ``n_chips > 1``."""
    n, np_ = hw.max_neurons, hw.max_post_neurons
    m_chip = hw.spus_per_chip
    s_um, k, ww = hw.unified_mem_depth, hw.concentration, hw.weight_bits
    ot_entry = 2 * _lg(s_um) + _lg(k) + _lg(n) + 2
    halves = 0
    halves += math.ceil(n * m_chip / (bram_kbits * 1024))            # routing
    halves += m_chip * math.ceil(op_table_depth * ot_entry
                                 / (bram_kbits * 1024))
    halves += m_chip * math.ceil(k * ww * s_um / (bram_kbits * 1024))  # UM
    halves += m_chip * math.ceil(n / (bram_kbits * 1024))          # spike mem
    halves += math.ceil(np_ * (_lg(n) + k * ww - _lg(np_) + 1)
                        / (bram_kbits * 1024))                     # NU state
    return hw.n_chips * halves / 2.0
