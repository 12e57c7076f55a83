"""Synaptic accumulation ``I = S @ W`` with the spike-tile skip in one
CUDA kernel; port of ``repro/kernels/spike_accum.py``.

The paper's per-event skip (SPUs idle on pre neurons that did not fire)
becomes, on the card as on the TPU, a skip of every weight tile whose
spike tile is all zero, and each output is summed in one fixed order, so
a float result is the same from run to run. :func:`spike_accum`
launches ``csrc/spike_accum.cu`` for CUDA tensors and runs
:func:`spike_accum_ref`, its plain torch version, for CPU tensors; its
design and what bounds it on the H100 are noted in the source.
:class:`SpikeAccumFn` puts it under autograd with a plain torch backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import contract_int32

# input dtype -> the kernel's type code; spikes and weights share one
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
MAX_BATCH = 65535 * 8                  # the kernel's grid.y limit x 8 rows


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def spike_accum_ref(spikes: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """Dense ``I = S @ W``; port of ``repro/kernels/ref.py::spike_accum_ref``.

    spikes [B, N_pre] (0/1, any numeric dtype), weights [N_pre, N_post]
    -> [B, N_post] in float32, or int32 (wrapping) for integer weights.
    """
    if _is_integer(weights.dtype):
        return contract_int32(spikes.to(torch.int32), weights)
    return spikes.to(torch.float32) @ weights.to(torch.float32)


def spike_accum(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``I = S @ W`` skipping weight tiles whose spike tile is all zero.

    spikes [B, N_pre] and weights [N_pre, N_post], contiguous, of one
    dtype: float32 or bfloat16 (summed in float32, returned float32) or
    int32 (summed in int32, wrapping). CUDA tensors launch
    ``csrc/spike_accum.cu`` (counted in ``spike_accum.launches``); CPU
    tensors run :func:`spike_accum_ref`.
    """
    if spikes.ndim != 2 or weights.ndim != 2 \
            or spikes.shape[1] != weights.shape[0]:
        raise ValueError(f"spikes {tuple(spikes.shape)} x weights "
                         f"{tuple(weights.shape)}: want [B, N_pre] x "
                         f"[N_pre, N_post]")
    if spikes.dtype != weights.dtype or spikes.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"spikes {spikes.dtype} and weights {weights.dtype}"
                         f": want one dtype of {tuple(_KERNEL_DTYPES)}")
    if spikes.device != weights.device:
        raise ValueError(f"spikes on {spikes.device}, weights on "
                         f"{weights.device}")
    if not (spikes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("spikes and weights must be contiguous")
    if spikes.device.type == "cpu":
        return spike_accum_ref(spikes, weights)
    if spikes.device.type != "cuda":
        raise ValueError(f"spike_accum runs on cuda or cpu, not "
                         f"{spikes.device}")
    b, n_pre = spikes.shape
    n_post = weights.shape[1]
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} > {MAX_BATCH}, the kernel's grid limit")
    out = torch.empty((b, n_post), device=spikes.device,
                      dtype=torch.int32 if spikes.dtype == torch.int32
                      else torch.float32)
    if b and n_post:
        lib = _build.load_library()
        with torch.cuda.device(spikes.device):
            err = lib.suprasnn_spike_accum(
                spikes.data_ptr(), weights.data_ptr(), out.data_ptr(),
                _KERNEL_DTYPES[spikes.dtype], b, n_pre, n_post,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "spike_accum")
        spike_accum.launches += 1
    return out


spike_accum.launches = 0


class SpikeAccumFn(torch.autograd.Function):
    """:func:`spike_accum` under autograd: ``SpikeAccumFn.apply(spikes,
    weights)``. Backward ``g @ W^T`` and ``S^T @ g`` with
    ``torch.matmul``: plain matrix products, which the JAX package too
    leaves to autodiff outside any kernel."""

    @staticmethod
    def forward(ctx, spikes, weights):
        ctx.save_for_backward(spikes, weights)
        return spike_accum(spikes, weights)

    @staticmethod
    def backward(ctx, g):
        spikes, weights = ctx.saved_tensors
        g_s = g_w = None
        if ctx.needs_input_grad[0]:
            g_s = (g @ weights.to(g.dtype).T).to(spikes.dtype)
        if ctx.needs_input_grad[1]:
            g_w = (spikes.to(g.dtype).T @ g).to(weights.dtype)
        return g_s, g_w
