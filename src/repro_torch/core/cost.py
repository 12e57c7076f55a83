"""FPGA resource model (LUT/FF/BRAM); port of ``repro/core/cost.py``.

LUT/FF constants are fitted to the two implementation points of paper
Table 2 (XC7Z020/MNIST and XC7Z030/SHD). :func:`resources` needs the
memory model (Eqs. 9-11) for its BRAM and memory figures, which waits
for the compiler slice; a loaded artifact carries its
:class:`ResourceReport` in the header.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.memory_model import HardwareConfig


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    lut_fixed: float = 800.0     # trees + injector + handler + NU control
    lut_per_spu: float = 72.56
    lut_per_spu_bit: float = 7.855
    ff_fixed: float = 800.0
    ff_per_spu: float = 68.47
    ff_per_spu_bit: float = 8.03

    def luts(self, hw: HardwareConfig) -> int:
        bits = hw.weight_bits + hw.potential_bits
        return int(self.lut_fixed
                   + hw.n_spus * (self.lut_per_spu + bits * self.lut_per_spu_bit))

    def ffs(self, hw: HardwareConfig) -> int:
        bits = hw.weight_bits + hw.potential_bits
        return int(self.ff_fixed
                   + hw.n_spus * (self.ff_per_spu + bits * self.ff_per_spu_bit))


@dataclasses.dataclass
class ResourceReport:
    luts: int
    ffs: int
    brams: float
    memory_kb: float


def resources(hw: HardwareConfig, ot_depth: int,
              model: ResourceModel | None = None) -> ResourceReport:
    raise NotImplementedError(
        "resources() needs the memory model (Eqs. 9-11), which the port "
        "does not have yet (ROADMAP Queue A item 7)")
