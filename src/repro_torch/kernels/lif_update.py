"""Fused LIF membrane update in one CUDA kernel, the centralized Neuron
Unit; port of ``repro/kernels/lif_update.py``.

Leak, integrate, threshold and reset (paper Eqs. 2/4/5) fused into one
elementwise pass. The kernels, all in ``csrc/lif_update.cu``:

* :func:`lif_update` — float32, the training side's LIF step:
  ``u = (1 - alpha) v + I``, spike iff ``u >= v_th``, reset to
  ``v_reset``; bit-exact with :func:`lif_update_ref` (the kernel rounds
  the multiply and the add apart, as torch does);
* :func:`lif_update_bwd` — that step's gradient in one pass (the JAX
  package leaves it to autodiff of ``lif_step``; no TPU kernel), within
  float32 roundings of :func:`lif_update_bwd_ref`;
* :func:`lif_update_int` — int32 with the hardware's shift leak
  ``v - (v >> shift) + I``, bit-exact with
  :func:`repro_torch.snn.lif.lif_step_int`; the Neuron Unit of the
  engine's ``"lif"`` tier.

Each public wrapper checks its operands, launches its kernel for CUDA
tensors and runs its plain torch version (``*_ref``) for CPU tensors.
The hot paths launch without checks, on operands their caller checked
once: :class:`LIFUpdateFn` (the training forward and backward, through
:func:`launch_lif_update` and :func:`launch_lif_update_bwd`, with the
recurrent layer's two currents added inside the kernel) and the
``"lif"`` tier's step loop (:func:`lif_int_launcher`, which also drains
the engine's current plane).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import count_launch
from repro_torch.snn.lif import (SURROGATES, LIFIntParams, LIFParams,
                                 check_surrogate, lif_step_int,
                                 surrogate_grad)

_INT32 = (-(2 ** 31), 2 ** 31 - 1)


def check_params(p: LIFIntParams) -> None:
    """Reject parameters the kernels cannot take as C ints."""
    if p.leak_shift < 0:
        raise ValueError(f"leak_shift must be >= 0, got {p.leak_shift}")
    for name in ("v_threshold", "v_reset"):
        if not _INT32[0] <= getattr(p, name) <= _INT32[1]:
            raise ValueError(f"{name}={getattr(p, name)} outside int32")


def _check_args(dtype: torch.dtype, v: torch.Tensor,
                **others: torch.Tensor | None) -> None:
    """Every tensor (``None`` skipped) on v's device, of v's [B, N] or
    [N] shape, of ``dtype``, contiguous."""
    for name, t in {"v": v, **others}.items():
        if t is None:
            continue
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


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# -- float32 forward -----------------------------------------------------------

def lif_update_ref(v: torch.Tensor, current: torch.Tensor, alpha: float,
                   v_th: float, v_reset: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`lif_update`; port of
    ``repro/kernels/ref.py::lif_update_ref``. Spikes are 0/1 float32."""
    v_upd = (1.0 - alpha) * v + current
    s = (v_upd >= v_th).to(v.dtype)
    return torch.where(s > 0, v_reset, v_upd), s


def launch_lif_update(v: torch.Tensor, current: torch.Tensor,
                      current_rec: torch.Tensor | None, v_out: torch.Tensor,
                      s_out: torch.Tensor, alpha: float, v_th: float,
                      v_reset: float, stream: int) -> None:
    """Launch the float step with no checks: every tensor a contiguous
    float32 CUDA tensor of v's shape on the current device,
    ``current_rec`` (the recurrent plane, added to ``current`` in the
    kernel, rounded as torch's ``current + current_rec``) or ``None``,
    ``v_out`` may be ``v``; ``stream`` a raw stream handle. Counted in
    ``lif_update.launches``."""
    n = v.numel()
    if n:
        err = _build.load_library().suprasnn_lif_update(
            v.data_ptr(), current.data_ptr(), _ptr(current_rec),
            v_out.data_ptr(), s_out.data_ptr(), n, 1.0 - alpha, v_th,
            v_reset, stream)
        _build.check(err, "lif_update")
        count_launch(lif_update)


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
    _check_args(torch.float32, v, current=current,
                v_out=None if out is None else out[0],
                s_out=None if out is None else out[1])
    if v.device.type == "cpu":
        v_next, spikes = lif_update_ref(v, current, alpha, v_th, v_reset)
        if out is not None:
            v_next, spikes = out[0].copy_(v_next), out[1].copy_(spikes)
        return v_next, spikes
    v_out, s_out = out if out is not None else (torch.empty_like(v),
                                                torch.empty_like(v))
    with _build.on_device(v.device):
        launch_lif_update(v, current, None, v_out, s_out, alpha, v_th,
                          v_reset, _build.stream_handle(v.device))
    return v_out, s_out


lif_update.launches = 0


# -- float32 backward ----------------------------------------------------------

def lif_update_bwd_ref(v: torch.Tensor, current: torch.Tensor,
                       g_vnext: torch.Tensor | None,
                       g_s: torch.Tensor | None, alpha: float, v_th: float,
                       surrogate: str,
                       current_rec: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the reference's ``lif_step`` in plain torch:
    ``(g_v, g_current)``. With ``u = (1-a) v + I`` (``I = current +
    current_rec``; the forward's roundings) and ``s = [u >= th]``:
    ``g_u = g_vnext (1 - s) + g_s surr(u - th)``, ``g_v = (1-a) g_u``,
    ``g_I = g_u``; the reset passes no gradient where the neuron spiked.
    A ``None`` gradient is zero."""
    if current_rec is not None:
        current = current + current_rec
    u = (1.0 - alpha) * v + current
    if g_vnext is None:
        g_u = torch.zeros_like(v)
    else:
        g_u = torch.where(u >= v_th, 0.0, g_vnext)
    if g_s is not None:
        g_u = g_u + g_s * surrogate_grad(u - v_th, surrogate)
    return (1.0 - alpha) * g_u, g_u


def launch_lif_update_bwd(v: torch.Tensor, current: torch.Tensor,
                          current_rec: torch.Tensor | None,
                          g_vnext: torch.Tensor | None,
                          g_s: torch.Tensor | None, g_v: torch.Tensor,
                          g_current: torch.Tensor, alpha: float,
                          v_th: float, surrogate: str, stream: int) -> None:
    """Launch the gradient kernel with no checks: as
    :func:`launch_lif_update`, ``g_vnext`` and ``g_s`` may be ``None``
    (zero), ``g_v`` and ``g_current`` are written. Counted in
    ``lif_update_bwd.launches``."""
    n = v.numel()
    if n:
        err = _build.load_library().suprasnn_lif_update_bwd(
            v.data_ptr(), current.data_ptr(), _ptr(current_rec),
            _ptr(g_vnext), _ptr(g_s), g_v.data_ptr(), g_current.data_ptr(),
            n, 1.0 - alpha, v_th, SURROGATES.index(surrogate), stream)
        _build.check(err, "lif_update_bwd")
        count_launch(lif_update_bwd)


def lif_update_bwd(v: torch.Tensor, current: torch.Tensor,
                   g_vnext: torch.Tensor | None, g_s: torch.Tensor | None,
                   *, alpha: float, v_th: float = 1.0,
                   surrogate: str = "relu",
                   current_rec: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float LIF step's gradient on [B, N] or [N] float32:
    ``(g_v, g_current)`` given the step's inputs and the gradients of
    ``v_next`` and ``spikes`` (either may be ``None``: zero). CUDA
    tensors launch ``csrc/lif_update.cu`` (counted in
    ``lif_update_bwd.launches``); CPU tensors run
    :func:`lif_update_bwd_ref`."""
    check_surrogate(surrogate)
    _check_args(torch.float32, v, current=current, current_rec=current_rec,
                g_vnext=g_vnext, g_s=g_s)
    if v.device.type == "cpu":
        return lif_update_bwd_ref(v, current, g_vnext, g_s, alpha, v_th,
                                  surrogate, current_rec)
    g_v, g_current = torch.empty_like(v), torch.empty_like(v)
    with _build.on_device(v.device):
        launch_lif_update_bwd(v, current, current_rec, g_vnext, g_s, g_v,
                              g_current, alpha, v_th, surrogate,
                              _build.stream_handle(v.device))
    return g_v, g_current


lif_update_bwd.launches = 0


class LIFUpdateFn(torch.autograd.Function):
    """:func:`repro_torch.snn.lif.lif_step` through the kernels, under
    autograd: ``LIFUpdateFn.apply(v, current, current_rec, p, surrogate)``
    -> ``(v_next, spikes)``, the step taking ``current + current_rec``
    (``current_rec`` ``None`` for a layer without recurrence; both
    currents get the same gradient).

    On the card both directions launch without checks
    (:func:`launch_lif_update`, :func:`launch_lif_update_bwd`): ``v``
    and the currents must be contiguous float32 tensors of one shape on
    the current device, as :func:`~repro_torch.snn.models.layer_spikes`
    checks once per forward. On the CPU they run the plain versions. An
    unused output's gradient is not made (``None`` reaches the kernel as
    zero), so the last step's ``v_next`` costs no ``zeros_like``.
    """

    @staticmethod
    def forward(ctx, v, current, current_rec, p: LIFParams, surrogate: str):
        check_surrogate(surrogate)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(v, current, current_rec)
        ctx.p, ctx.surrogate = p, surrogate
        if not v.is_cuda:
            total = current if current_rec is None else current + current_rec
            return lif_update_ref(v, total, p.alpha, p.v_threshold,
                                  p.v_reset)
        v_out, s_out = torch.empty_like(v), torch.empty_like(v)
        launch_lif_update(v, current, current_rec, v_out, s_out, p.alpha,
                          p.v_threshold, p.v_reset,
                          _build.stream_handle(v.device))
        return v_out, s_out

    @staticmethod
    def backward(ctx, g_vnext, g_s):
        v, current, current_rec = ctx.saved_tensors
        p = ctx.p
        if g_vnext is None and g_s is None:
            return None, None, None, None, None
        if not v.is_cuda:
            g_v, g_i = lif_update_bwd_ref(v, current, g_vnext, g_s, p.alpha,
                                          p.v_threshold, ctx.surrogate,
                                          current_rec)
        else:
            # autograd's gradients are the kernel's dtype and shape but
            # need not be laid out densely
            g_vnext = None if g_vnext is None else g_vnext.contiguous()
            g_s = None if g_s is None else g_s.contiguous()
            g_v, g_i = torch.empty_like(v), torch.empty_like(v)
            launch_lif_update_bwd(v, current, current_rec, g_vnext, g_s,
                                  g_v, g_i, p.alpha, p.v_threshold,
                                  ctx.surrogate,
                                  _build.stream_handle(v.device))
        return (g_v, g_i, None if current_rec is None else g_i, None, None)


# -- int32 ---------------------------------------------------------------------

def lif_update_int_ref(v: torch.Tensor, current: torch.Tensor,
                       p: LIFIntParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`lif_update_int`."""
    return lif_step_int(v, current, p)


def lif_int_launcher(p: LIFIntParams):
    """An unchecked launch of the int32 step for parameters checked
    once: the ``"lif"`` tier's path. Returns ``launch(v, current, v_out,
    s_out, n, stream)`` over raw pointers (ints) of contiguous int32
    buffers of ``n >= 1`` elements on the current device (``v_out`` may
    be ``v``) and a raw stream handle. The kernel zeroes ``current`` as
    it reads it: the Neuron Unit drains the Merge Tree's accumulator.
    Each launch counts in ``lif_update_int.launches``."""
    check_params(p)
    fn = _build.load_library().suprasnn_lif_update_int
    ls, th, reset = p.leak_shift, p.v_threshold, p.v_reset

    def launch(v, current, v_out, s_out, n, stream):
        err = fn(v, current, v_out, s_out, n, ls, th, reset, 1, stream)
        _build.check(err, "lif_update_int")
        count_launch(lif_update_int)

    return launch


def lif_update_int(v: torch.Tensor, current: torch.Tensor, p: LIFIntParams,
                   *, out: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int32 LIF step on [B, N] or [N] tensors: ``(v_next, spikes)``.

    ``out=(v_out, s_out)`` names where to write; ``v_out`` may be ``v``
    itself (an in-place update). ``current`` is left as it is. CUDA
    tensors launch ``csrc/lif_update.cu`` (counted in
    ``lif_update_int.launches``); CPU tensors run
    :func:`lif_update_int_ref`.
    """
    _check_args(torch.int32, v, current=current,
                v_out=None if out is None else out[0],
                s_out=None if out is None else out[1])
    check_params(p)
    if v.device.type == "cpu":
        v_next, spikes = lif_update_int_ref(v, current, p)
        if out is not None:
            v_next, spikes = out[0].copy_(v_next), out[1].copy_(spikes)
        return v_next, spikes
    v_out, s_out = out if out is not None else (torch.empty_like(v),
                                                torch.empty_like(v))
    if v.numel():
        with _build.on_device(v.device):
            err = _build.load_library().suprasnn_lif_update_int(
                v.data_ptr(), current.data_ptr(), v_out.data_ptr(),
                s_out.data_ptr(), v.numel(), p.leak_shift, p.v_threshold,
                p.v_reset, 0, _build.stream_handle(v.device))
        _build.check(err, "lif_update_int")
        count_launch(lif_update_int)
    return v_out, s_out


lif_update_int.launches = 0
