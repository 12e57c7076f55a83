"""The int32 Neuron Unit in one CUDA kernel; port of ``lif_update_int``
from ``repro/kernels/lif_update.py``.

Leak, integrate, threshold and reset fused into one elementwise pass
(paper Eqs. 2/4/5): ``v' = v - (v >> shift) + I``, spike iff
``v' >= v_th``, reset to ``v_reset``; bit-exact with
:func:`repro_torch.snn.lif.lif_step_int`. :func:`lif_update_int`
launches ``csrc/lif_update.cu`` for CUDA tensors and runs
:func:`lif_update_int_ref` for CPU tensors. The float ``lif_update``
is not on this slice's path (ROADMAP Queue B item 4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.snn.lif import LIFIntParams, lif_step_int

_INT32 = (-(2 ** 31), 2 ** 31 - 1)


def check_params(p: LIFIntParams) -> None:
    """Reject parameters the kernels cannot take as C ints."""
    if p.leak_shift < 0:
        raise ValueError(f"leak_shift must be >= 0, got {p.leak_shift}")
    for name in ("v_threshold", "v_reset"):
        if not _INT32[0] <= getattr(p, name) <= _INT32[1]:
            raise ValueError(f"{name}={getattr(p, name)} outside int32")


def lif_update_int_ref(v: torch.Tensor, current: torch.Tensor,
                       p: LIFIntParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`lif_update_int`."""
    return lif_step_int(v, current, p)


def lif_update_int(v: torch.Tensor, current: torch.Tensor, p: LIFIntParams,
                   *, out: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int32 LIF step on [B, N] or [N] tensors: ``(v_next, spikes)``.

    ``out=(v_out, s_out)`` names where to write; ``v_out`` may be ``v``
    itself (an in-place update). CUDA tensors launch
    ``csrc/lif_update.cu`` (counted in ``lif_update_int.launches``); CPU
    tensors run :func:`lif_update_int_ref`.
    """
    tensors = {"v": v, "current": current}
    if out is not None:
        tensors.update(v_out=out[0], s_out=out[1])
    for name, t in tensors.items():
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if t.shape != v.shape or t.ndim not in (1, 2):
            raise ValueError(f"{name} shape {tuple(t.shape)}: want [B, N] "
                             f"or [N] equal to v's {tuple(v.shape)}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} dtype {t.dtype} != torch.int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_params(p)

    if v.device.type == "cpu":
        v_next, spikes = lif_update_int_ref(v, current, p)
        if out is not None:
            v_next, spikes = out[0].copy_(v_next), out[1].copy_(spikes)
        return v_next, spikes
    if v.device.type != "cuda":
        raise ValueError(f"lif_update_int runs on cuda or cpu, not "
                         f"{v.device}")
    v_out, s_out = out if out is not None else (torch.empty_like(v),
                                                torch.empty_like(v))
    if v.numel():
        lib = _build.load_library()
        with torch.cuda.device(v.device):
            err = lib.suprasnn_lif_update_int(
                v.data_ptr(), current.data_ptr(), v_out.data_ptr(),
                s_out.data_ptr(), v.numel(), p.leak_shift, p.v_threshold,
                p.v_reset, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "lif_update_int")
        lif_update_int.launches += 1
    return v_out, s_out


lif_update_int.launches = 0
