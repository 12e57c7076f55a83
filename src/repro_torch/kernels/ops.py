"""Public wrappers around the CUDA kernels; port of
``repro/kernels/ops.py``.

The reference's names, signatures and defaults, so that a caller of
``repro.kernels.ops`` can switch packages. Each delegates to the port's
kernel module, whose rule holds: a CUDA tensor launches the kernel (and
a kernel that fails to build or launch raises), a CPU tensor runs the
plain torch version.

* The tile keywords (``block_b``, ``block_pre``, ``block_post``,
  ``block``, ``chunk``) tile the reference's Pallas kernels for the
  TPU's memory; the function computes the same result whatever they
  are, and the CUDA kernels choose their own tiles. They are accepted
  and ignored.
* ``interpret=True`` asks for the plain version: the ``*_ref`` function
  runs on the tensors' device, card or CPU. ``None`` and ``False`` keep
  the package's rule above.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lif_update import lif_update as _lif_update
from repro_torch.kernels.lif_update import lif_update_int as _lif_update_int
from repro_torch.kernels.lif_update import lif_update_int_ref, lif_update_ref
from repro_torch.kernels.ref import ssd_ref, wkv6_ref
from repro_torch.kernels.spike_accum import spike_accum as _spike_accum
from repro_torch.kernels.spike_accum import spike_accum_ref
from repro_torch.kernels.ssd import ssd as _ssd
from repro_torch.kernels.wkv6 import wkv6 as _wkv6
from repro_torch.snn.lif import LIFIntParams


def spike_accum(spikes: torch.Tensor, weights: torch.Tensor, *, block_b=8,
                block_pre=128, block_post=128, interpret=None
                ) -> torch.Tensor:
    """``I = S @ W`` (:func:`repro_torch.kernels.spike_accum.spike_accum`)."""
    if interpret:
        return spike_accum_ref(spikes, weights)
    return _spike_accum(spikes, weights)


def lif_update(v: torch.Tensor, current: torch.Tensor, *, alpha: float,
               v_th: float = 1.0, v_reset: float = 0.0, block=(8, 128),
               interpret=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One float LIF step
    (:func:`repro_torch.kernels.lif_update.lif_update`)."""
    if interpret:
        return lif_update_ref(v, current, alpha, v_th, v_reset)
    return _lif_update(v, current, alpha=alpha, v_th=v_th, v_reset=v_reset)


def lif_update_int(v: torch.Tensor, current: torch.Tensor, p: LIFIntParams,
                   *, block=(8, 128), interpret=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One int32 LIF step
    (:func:`repro_torch.kernels.lif_update.lif_update_int`)."""
    if interpret:
        return lif_update_int_ref(v, current, p)
    return _lif_update_int(v, current, p)


def wkv6(r, k, v, w_log, u, state0, *, chunk=64, interpret=None) -> tuple:
    """WKV-6 over a sequence (:func:`repro_torch.kernels.wkv6.wkv6`)."""
    if interpret:
        return wkv6_ref(r, k, v, w_log, u, state0)
    return _wkv6(r, k, v, w_log, u, state0)


def ssd(x, dt, a_log, b, c, state0, *, chunk=64, interpret=None) -> tuple:
    """SSD over a sequence (:func:`repro_torch.kernels.ssd.ssd`)."""
    if interpret:
        return ssd_ref(x, dt, a_log, b, c, state0)
    return _ssd(x, dt, a_log, b, c, state0)
