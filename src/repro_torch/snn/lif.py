"""Discrete-time LIF neuron dynamics with surrogate gradients; port of
``repro/snn/lif.py``.

The float path (``LIFParams``, ``spike_fn``, ``lif_step``) is what BPTT
training differentiates; the integer path (``lif_step_int``) is the
reference the engine tiers must reproduce bit-exactly.

SupraSNN implements the leak with a programmable right shift:
``(1 - alpha) V == V - (V >> shift)``. ``>>`` on an int32 torch tensor
is an arithmetic shift, as ``lax.shift_right_arithmetic`` is in the
reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SURROGATES = ("relu", "sigmoid", "fast_sigmoid")


class LIFParams(NamedTuple):
    """Neuron-model constants (paper Table 2)."""
    alpha: float = 0.25        # leak factor; (1 - alpha) V + I
    v_threshold: float = 1.0
    v_reset: float = 0.0


def check_surrogate(surrogate: str) -> None:
    if surrogate not in SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate!r}; use one of "
                         f"{SURROGATES}")


def surrogate_grad(v_minus_th: torch.Tensor, surrogate: str) -> torch.Tensor:
    """The surrogate that stands in for the Heaviside step's derivative
    (paper Table 2: ReLU for MNIST, sigmoid for SHD), written as the
    reference writes it so that the float operations round alike."""
    check_surrogate(surrogate)
    if surrogate == "relu":
        # triangle ("ReLU of 1-|x|")
        return torch.clamp(1.0 - torch.abs(v_minus_th), min=0.0)
    if surrogate == "sigmoid":
        k = 4.0
        s = torch.sigmoid(k * v_minus_th)
        return k * s * (1.0 - s)
    k = 10.0                                           # fast_sigmoid
    return 1.0 / (1.0 + k * torch.abs(v_minus_th)) ** 2


class SpikeFn(torch.autograd.Function):
    """Heaviside step of Eq. (4) forward, surrogate gradient backward."""

    @staticmethod
    def forward(ctx, v_minus_th: torch.Tensor, surrogate: str) -> torch.Tensor:
        ctx.save_for_backward(v_minus_th)
        ctx.surrogate = surrogate
        return (v_minus_th >= 0.0).to(v_minus_th.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (v_minus_th,) = ctx.saved_tensors
        return g * surrogate_grad(v_minus_th, ctx.surrogate), None


def spike_fn(v_minus_th: torch.Tensor, surrogate: str = "relu"
             ) -> torch.Tensor:
    check_surrogate(surrogate)
    return SpikeFn.apply(v_minus_th, surrogate)


def lif_step(v: torch.Tensor, current: torch.Tensor, p: LIFParams,
             surrogate: str = "relu") -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep in plain torch. Returns ``(v_next, spikes)``.

    Eq. (2): V_upd = (1 - alpha) V + I
    Eq. (4): S = [V_upd >= V_th]
    Eq. (5): V_next = V_reset if S else V_upd
    """
    v_upd = (1.0 - p.alpha) * v + current
    s = spike_fn(v_upd - p.v_threshold, surrogate)
    v_next = torch.where(s > 0, p.v_reset, v_upd)
    return v_next, s


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


def alpha_to_shift(alpha: float) -> int:
    """Nearest power-of-two approximation of the leak factor (paper §5)."""
    return int(round(-np.log2(alpha)))
