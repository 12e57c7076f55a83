"""Synaptic accumulation ``I = S @ W`` with the spike-tile skip in one
CUDA kernel; port of ``repro/kernels/spike_accum.py``.

The paper's per-event skip (SPUs idle on pre neurons that did not fire)
becomes, on the card as on the TPU, a skip of every weight tile whose
spike tile is all zero, and each output is summed in one fixed order, so
a float result is the same from run to run. :func:`spike_accum`
launches ``csrc/spike_accum.cu`` for CUDA tensors and runs
:func:`spike_accum_ref`, its plain torch version, for CPU tensors; its
design and what bounds it on the H100 are noted in the source.
:func:`launch_spike_accum` is the same launch with no checks, for
operands already known good. :func:`split_bf16x3` and
:func:`spike_accum_emulated` replay the kernel's float32 split and its
schedule in plain torch for the tests. :class:`SpikeAccumFn` puts it
under autograd (the training forward's unchecked launch) with a plain
torch backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contract import KSTEP, kstep_ranges
from repro_torch.kernels.fused_step import contract_int32

# input dtype -> the kernel's type code; spikes and weights share one
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
TILE_B = 16                            # a CTA's batch rows
WARP_N = 8                             # a warp's post neurons (4 a CTA)
MAX_BATCH = 65535 * TILE_B             # the kernel's grid.y limit x rows


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


def split_bf16x3(w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's exact split of float32 ``w`` into three bf16 terms:
    ``hi = bf16(w)``, ``mid = bf16(w - hi)``, ``lo = bf16(w - hi - mid)``
    (each rounded to nearest even, each difference exact in float32).
    ``hi + mid + lo == w`` wherever :func:`splittable` holds."""
    hi = w.to(torch.bfloat16)
    r1 = w - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def splittable(w: torch.Tensor) -> torch.Tensor:
    """Where :func:`split_bf16x3` holds float32 ``w`` exactly: zero, or a
    magnitude in [2^-100, 2^127) (every term then a normal bf16 that
    cannot round to infinity)."""
    a = w.abs()
    return (w == 0) | ((a >= 2.0 ** -100) & (a < 2.0 ** 127))


def spike_accum_emulated(spikes: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """``csrc/spike_accum.cu``'s schedule replayed in plain torch, for the
    tests: per tile of 16 batch rows x 8 post neurons (one warp's part
    of a CTA's 32), the pre axis in K-steps of 32 split over the
    cluster's ranks; a K-step with no spike in the tile's rows is
    skipped; each rank sums its K-steps in ascending order into its
    partial tile and the ranks' tiles are added in rank order. A float32
    K-step of 0/1 spikes whose weights (in the warp's columns) all split
    takes
    the three bf16 products (exact, summed in float32: the tensor cores'
    products), each term into its own sum, the rank's partial being
    ``hi + (lo + mid)``; any other float32 K-step one multiply-add per
    pre neuron (the kernel's FFMA) into the ``hi`` sum; bf16 one exact product; int32 exact
    products wrapping in int32."""
    dt = spikes.dtype
    b, n_pre = spikes.shape
    n_post = weights.shape[1]
    integer = dt == torch.int32
    acc_dt = torch.int64 if integer else torch.float32
    s_all = spikes.to(acc_dt)
    out = torch.zeros((b, n_post), dtype=acc_dt)
    n_ks = -(-n_pre // KSTEP)
    for b0 in range(0, b, TILE_B):
        for n0 in range(0, n_post, WARP_N):
            s_t = s_all[b0:b0 + TILE_B]
            w_t = weights[:, n0:n0 + WARP_N]
            total = None
            for k0, k1 in kstep_ranges(n_ks):
                part = torch.zeros((s_t.shape[0], w_t.shape[1]),
                                   dtype=acc_dt)
                mid_lo = [torch.zeros_like(part), torch.zeros_like(part)]
                for ks in range(k0, k1):
                    cols = slice(ks * KSTEP, min((ks + 1) * KSTEP, n_pre))
                    s, w = s_t[:, cols], w_t[cols]
                    if not s.any():
                        continue                # the MC-tree skip
                    if integer:
                        part += s @ w.to(torch.int64)
                    elif dt == torch.bfloat16:
                        part += s @ w.to(torch.float32)
                    elif ((s != 0) & (s != 1)).any() \
                            or not splittable(w).all():
                        for k in range(s.shape[1]):
                            part = torch.addcmul(part, s[:, k:k + 1],
                                                 w[k:k + 1])
                    else:
                        hi, mid, lo = split_bf16x3(w)
                        part += s @ hi.to(torch.float32)
                        mid_lo[0] += s @ mid.to(torch.float32)
                        mid_lo[1] += s @ lo.to(torch.float32)
                if not integer:
                    part = part + (mid_lo[1] + mid_lo[0])
                total = part if total is None else total + part
            out[b0:b0 + TILE_B, n0:n0 + WARP_N] = total
    if integer:
        out = out & (2 ** 32 - 1)
        return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    return out


def launch_spike_accum(spikes: torch.Tensor, weights: torch.Tensor,
                       out: torch.Tensor, stream: int) -> torch.Tensor:
    """Launch ``csrc/spike_accum.cu`` with no checks: the operands are
    contiguous CUDA tensors on the current device that
    :func:`spike_accum` would take, ``out`` is its output buffer, and
    ``stream`` a raw stream handle. Counted in ``spike_accum.launches``."""
    b, n_pre = spikes.shape
    err = _build.load_library().suprasnn_spike_accum(
        spikes.data_ptr(), weights.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[spikes.dtype], b, n_pre, weights.shape[1], stream)
    _build.check(err, "spike_accum")
    spike_accum.launches += 1
    return out


def spike_accum(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``I = S @ W`` skipping K-steps whose spikes are all zero.

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
    dt, dev = spikes.dtype, spikes.device
    if dt != weights.dtype or dt not in _KERNEL_DTYPES:
        raise ValueError(f"spikes {dt} and weights {weights.dtype}"
                         f": want one dtype of {tuple(_KERNEL_DTYPES)}")
    if dev != weights.device:
        raise ValueError(f"spikes on {dev}, weights on {weights.device}")
    if not (spikes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("spikes and weights must be contiguous")
    if dev.type == "cpu":
        return spike_accum_ref(spikes, weights)
    if dev.type != "cuda":
        raise ValueError(f"spike_accum runs on cuda or cpu, not {dev}")
    b = spikes.shape[0]
    n_post = weights.shape[1]
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} > {MAX_BATCH}, the kernel's grid limit")
    out = spikes.new_empty((b, n_post), dtype=torch.int32
                           if dt == torch.int32 else torch.float32)
    if b and n_post:
        with _build.on_device(dev):
            launch_spike_accum(spikes, weights, out,
                               _build.stream_handle(dev))
    return out


spike_accum.launches = 0


class SpikeAccumFn(torch.autograd.Function):
    """:func:`spike_accum` under autograd: ``SpikeAccumFn.apply(spikes,
    weights)``. On the card the forward launches without checks
    (:func:`launch_spike_accum`): the operands must be what
    :func:`spike_accum` takes, on the current device, as
    :func:`~repro_torch.snn.models.layer_spikes` checks once per
    forward; on the CPU it is :func:`spike_accum`. Backward ``g @ W^T``
    and ``S^T @ g`` with ``torch.matmul``: plain matrix products, which
    the JAX package too leaves to autodiff outside any kernel."""

    @staticmethod
    def forward(ctx, spikes, weights):
        ctx.save_for_backward(spikes, weights)
        if not spikes.is_cuda:
            return spike_accum(spikes, weights)
        out = spikes.new_empty((spikes.shape[0], weights.shape[1]),
                               dtype=torch.int32 if spikes.dtype == torch.int32
                               else torch.float32)
        if out.numel():
            launch_spike_accum(spikes, weights, out,
                               _build.stream_handle(spikes.device))
        return out

    @staticmethod
    def backward(ctx, g):
        spikes, weights = ctx.saved_tensors
        g_s = g_w = None
        if ctx.needs_input_grad[0]:
            g_s = (g @ weights.to(g.dtype).T).to(spikes.dtype)
        if ctx.needs_input_grad[1]:
            g_w = (spikes.to(g.dtype).T @ g).to(weights.dtype)
        return g_s, g_w
