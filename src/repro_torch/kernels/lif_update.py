"""Fused LIF membrane update in one CUDA kernel, the centralized Neuron
Unit; port of ``repro/kernels/lif_update.py``.

Leak, integrate, threshold and reset (paper Eqs. 2/4/5) fused into one
elementwise pass. Two variants, both in ``csrc/lif_update.cu``:

* :func:`lif_update` — float32, the training side's LIF step:
  ``u = (1 - alpha) v + I``, spike iff ``u >= v_th``, reset to
  ``v_reset``; bit-exact with :func:`lif_update_ref` (the kernel rounds
  the multiply and the add apart, as torch does). :class:`LIFUpdateFn`
  puts it under autograd with a plain torch backward;
* :func:`lif_update_int` — int32 with the hardware's shift leak
  ``v - (v >> shift) + I``, bit-exact with
  :func:`repro_torch.snn.lif.lif_step_int`; the Neuron Unit of the
  engine's ``"lif"`` tier.

Each wrapper launches its kernel for CUDA tensors and runs its plain
torch version (``*_ref``) for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.snn.lif import (LIFIntParams, LIFParams, check_surrogate,
                                 lif_step_int, surrogate_grad)

_INT32 = (-(2 ** 31), 2 ** 31 - 1)


def check_params(p: LIFIntParams) -> None:
    """Reject parameters the kernels cannot take as C ints."""
    if p.leak_shift < 0:
        raise ValueError(f"leak_shift must be >= 0, got {p.leak_shift}")
    for name in ("v_threshold", "v_reset"):
        if not _INT32[0] <= getattr(p, name) <= _INT32[1]:
            raise ValueError(f"{name}={getattr(p, name)} outside int32")


def _check_args(v: torch.Tensor, current: torch.Tensor,
                out: tuple[torch.Tensor, torch.Tensor] | None,
                dtype: torch.dtype) -> None:
    tensors = {"v": v, "current": current}
    if out is not None:
        tensors.update(v_out=out[0], s_out=out[1])
    for name, t in tensors.items():
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if t.shape != v.shape or t.ndim not in (1, 2):
            raise ValueError(f"{name} shape {tuple(t.shape)}: want [B, N] "
                             f"or [N] equal to v's {tuple(v.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the LIF kernels run on cuda or cpu, not "
                         f"{v.device}")


def lif_update_ref(v: torch.Tensor, current: torch.Tensor, alpha: float,
                   v_th: float, v_reset: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`lif_update`; port of
    ``repro/kernels/ref.py::lif_update_ref``. Spikes are 0/1 float32."""
    v_upd = (1.0 - alpha) * v + current
    s = (v_upd >= v_th).to(v.dtype)
    return torch.where(s > 0, v_reset, v_upd), s


def lif_update(v: torch.Tensor, current: torch.Tensor, *, alpha: float,
               v_th: float = 1.0, v_reset: float = 0.0,
               out: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused float LIF step on [B, N] or [N] float32: ``(v_next, spikes)``.

    ``out=(v_out, s_out)`` names where to write; ``v_out`` may be ``v``
    itself. ``1 - alpha``, ``v_th`` and ``v_reset`` are taken as float32,
    as torch takes a Python scalar beside a float32 tensor. CUDA tensors
    launch ``csrc/lif_update.cu`` (counted in ``lif_update.launches``);
    CPU tensors run :func:`lif_update_ref`.
    """
    _check_args(v, current, out, torch.float32)
    if v.device.type == "cpu":
        v_next, spikes = lif_update_ref(v, current, alpha, v_th, v_reset)
        if out is not None:
            v_next, spikes = out[0].copy_(v_next), out[1].copy_(spikes)
        return v_next, spikes
    v_out, s_out = out if out is not None else (torch.empty_like(v),
                                                torch.empty_like(v))
    if v.numel():
        lib = _build.load_library()
        with torch.cuda.device(v.device):
            err = lib.suprasnn_lif_update(
                v.data_ptr(), current.data_ptr(), v_out.data_ptr(),
                s_out.data_ptr(), v.numel(), 1.0 - alpha, v_th, v_reset,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "lif_update")
        lif_update.launches += 1
    return v_out, s_out


lif_update.launches = 0


class LIFUpdateFn(torch.autograd.Function):
    """:func:`repro_torch.snn.lif.lif_step` through the kernel, under
    autograd: ``LIFUpdateFn.apply(v, current, p, surrogate)`` ->
    ``(v_next, spikes)``. :func:`lif_update` forward; the gradient of the
    reference's ``lif_step`` backward, in plain torch (the JAX package
    has no backward kernel). With ``u = (1-a) v + I`` and ``s = [u >= th]``:
    ``g_u = g_vnext (1 - s) + g_s surr(u - th)``, ``g_v = (1-a) g_u``,
    ``g_I = g_u``; the reset passes no gradient where the neuron spiked.
    """

    @staticmethod
    def forward(ctx, v, current, p: LIFParams, surrogate: str):
        check_surrogate(surrogate)
        ctx.save_for_backward(v, current)
        ctx.p, ctx.surrogate = p, surrogate
        return lif_update(v, current, alpha=p.alpha, v_th=p.v_threshold,
                          v_reset=p.v_reset)

    @staticmethod
    def backward(ctx, g_vnext, g_s):
        v, current = ctx.saved_tensors
        p = ctx.p
        u = (1.0 - p.alpha) * v + current      # the kernel's two roundings
        g_u = (torch.where(u >= p.v_threshold, 0.0, g_vnext)
               + g_s * surrogate_grad(u - p.v_threshold, ctx.surrogate))
        return (1.0 - p.alpha) * g_u, g_u, None, None


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
    _check_args(v, current, out, torch.int32)
    check_params(p)

    if v.device.type == "cpu":
        v_next, spikes = lif_update_int_ref(v, current, p)
        if out is not None:
            v_next, spikes = out[0].copy_(v_next), out[1].copy_(spikes)
        return v_next, spikes
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
