"""Integer LIF neuron dynamics; port of ``repro/snn/lif.py`` (integer path).

SupraSNN implements the leak with a programmable right shift:
``(1 - alpha) V == V - (V >> shift)``. All arithmetic is int32 and is
the reference the engine tiers must reproduce bit-exactly. ``>>`` on an
int32 torch tensor is an arithmetic shift, as
``lax.shift_right_arithmetic`` is in the reference. The float training
path (``LIFParams``, ``lif_step``, ``spike_fn``) waits for the training
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LIFIntParams(NamedTuple):
    leak_shift: int            # alpha approximated as 2**-leak_shift
    v_threshold: int
    v_reset: int


def leak_int(v: torch.Tensor, shift: int) -> torch.Tensor:
    """V - (V >> shift), arithmetic shift (matches RTL two's-complement)."""
    return v - (v >> shift)


def lif_step_int(v: torch.Tensor, current: torch.Tensor, p: LIFIntParams
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer LIF step on int32 tensors: ``(v_next, spikes)``."""
    v_upd = leak_int(v, p.leak_shift) + current
    s = v_upd >= p.v_threshold
    return v_upd.masked_fill(s, p.v_reset), s.to(torch.int32)
