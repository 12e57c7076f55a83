"""Fused per-timestep step: route + accumulate + Neuron Unit in one CUDA
kernel; port of ``repro/kernels/fused_step.py``.

The lowered op stream is densified once per engine into a weight plane
``W[n_neurons, n_internal]`` with ``W[q, p] = Σ weight`` over all
(q -> p) synapses, packed to the narrowest signed dtype that holds every
entry (:func:`pack_dense`: int8 for the paper's 4-bit MNIST net, int16
for the 9-bit SHD net). One timestep is then the exact int32
contraction ``current = s_all @ W`` followed by the integer LIF
epilogue, with ``s_all = ext_t ‖ s_prev`` and one MC packet per nonzero
entry of ``s_all``.

:func:`fused_step` launches the hand-written kernel
``csrc/fused_step.cu`` for CUDA tensors and runs :func:`fused_step_ref`,
its plain torch version, for CPU tensors. Its design and what bounds it
on the H100 are noted in the source.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.analysis.ranges import dense_plane_bounds, min_safe_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.lif_update import check_params
from repro_torch.snn.lif import LIFIntParams, lif_step_int

# Densifying the op stream costs n_neurons * n_internal entries; past
# this many bytes the fused tier refuses and the caller should stay on
# the streaming "lif" tier (override via env for big-memory hosts).
MAX_DENSE_BYTES = int(os.environ.get("SUPRASNN_FUSED_MAX_BYTES",
                                     256 * 1024 * 1024))

_PLANE_DTYPES = (torch.int8, torch.int16, torch.int32)


@dataclasses.dataclass(frozen=True)
class DenseSynapses:
    """The lowered op stream as a packed dense weight plane.

    ``value_min``/``value_max`` are the exact bounds of the folded plane
    (min/max after summing duplicate (pre, post) ops).
    """
    weight: np.ndarray                  # [n_neurons, n_internal], int8/16/32
    n_neurons: int
    n_internal: int
    value_min: int = 0
    value_max: int = 0

    @property
    def dtype(self) -> np.dtype:
        return self.weight.dtype


def pack_dense(lowered) -> DenseSynapses:
    """Densify a :class:`~repro_torch.core.scheduling.LoweredProgram`.

    Sums duplicate (pre, post) ops exactly (int32), then packs to the
    narrowest signed dtype holding every summed entry; the bounds come
    from the range analysis before any densification, so the size-guard
    message can already name the dtype the plane would use.
    """
    n, m = lowered.n_neurons, lowered.n_internal
    lo, hi = dense_plane_bounds(lowered.op_pre, lowered.op_post_local,
                                lowered.op_weight, n, m)
    if n * m * 4 > MAX_DENSE_BYTES:
        raise ValueError(
            f"fused kernel tier would densify {n}x{m} weights "
            f"(> {MAX_DENSE_BYTES} bytes; plane values in [{lo}, {hi}], "
            f"minimal safe dtype {min_safe_dtype(lo, hi)}); use "
            f"kernel='lif' for this graph or raise "
            f"SUPRASNN_FUSED_MAX_BYTES")
    w = np.zeros((n, m), np.int32)
    np.add.at(w, (lowered.op_pre, lowered.op_post_local), lowered.op_weight)
    dt = np.dtype(min_safe_dtype(lo, hi))
    if dt.itemsize < 4:                 # int8/int16; int32 already holds it
        w = w.astype(dt)
    return DenseSynapses(weight=w, n_neurons=n, n_internal=m,
                         value_min=lo, value_max=hi)


def contract_int32(s_all: torch.Tensor, weight: torch.Tensor,
                   chunk_bytes: int = 64 * 2 ** 20) -> torch.Tensor:
    """Exact int32 ``s_all @ weight`` in plain torch, on any device.

    ``torch.matmul`` has no int32 kernel on CUDA, so this is an int64
    broadcast-multiply-sum over chunks of the pre axis (each chunk's
    [B, k, n_int] product kept under ``chunk_bytes``). int64 holds every
    partial sum exactly; the cast back to int32 wraps modulo 2**32, as
    the reference's int32 accumulation does.
    """
    b, n_all = s_all.shape
    n_int = weight.shape[1]
    step = max(1, chunk_bytes // (8 * max(1, b * n_int)))
    acc = torch.zeros((b, n_int), dtype=torch.int64, device=s_all.device)
    for k0 in range(0, n_all, step):
        s = s_all[:, k0:k0 + step, None].to(torch.int64)
        acc += (s * weight[k0:k0 + step].to(torch.int64)).sum(1)
    return acc.to(torch.int32)


def fused_step_ref(s_ext: torch.Tensor, s_prev: torch.Tensor,
                   v: torch.Tensor, weight: torch.Tensor, p: LIFIntParams
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fused_step`: ``(v_next, spikes,
    packet_counts)`` as new tensors; ``v`` is left as it was."""
    s_all = torch.cat([s_ext, s_prev], dim=1)
    pkt = (s_all != 0).sum(dim=1, dtype=torch.int32)
    v_next, spikes = lif_step_int(v, contract_int32(s_all, weight), p)
    return v_next, spikes, pkt


def _check_args(s_ext, s_prev, v, weight, p, spikes_out, pkt_out) -> None:
    b, n_int = v.shape
    want = {"s_ext": (s_ext, (b, s_ext.shape[1]), torch.int32),
            "s_prev": (s_prev, (b, n_int), torch.int32),
            "v": (v, (b, n_int), torch.int32),
            "weight": (weight, (s_ext.shape[1] + n_int, n_int), None),
            "spikes_out": (spikes_out, (b, n_int), torch.int32),
            "pkt_out": (pkt_out, (b,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.dtype not in _PLANE_DTYPES:
        raise ValueError(f"weight dtype {weight.dtype} not in {_PLANE_DTYPES}")
    check_params(p)


def fused_step(s_ext: torch.Tensor, s_prev: torch.Tensor, v: torch.Tensor,
               weight: torch.Tensor, p: LIFIntParams, *,
               spikes_out: torch.Tensor | None = None,
               pkt_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused timestep: ``(v, spikes, packet_counts)``.

    s_ext:  [B, n_ext] int32 external spikes of this step.
    s_prev: [B, n_int] int32 internal spikes of the previous step; the
            pre axis of ``weight`` is ``s_ext``'s columns, then these.
    v:      [B, n_int] int32 membrane state, updated in place (as the
            reference aliases it onto ``v_next``) and returned.
    weight: [n_ext + n_int, n_int] int8/int16/int32 packed plane
            (:func:`pack_dense`), accumulated in int32.
    spikes_out [B, n_int] / pkt_out [B] (int32): where to write the
            spikes and packet counts; allocated when not given.
            ``spikes_out`` must not be ``s_prev``.

    CUDA tensors launch ``csrc/fused_step.cu`` (counted in
    ``fused_step.launches``); CPU tensors run :func:`fused_step_ref`.
    """
    _check_args(s_ext, s_prev, v, weight, p, spikes_out, pkt_out)
    if v.device.type == "cpu":
        v_next, spikes, pkt = fused_step_ref(s_ext, s_prev, v, weight, p)
        v.copy_(v_next)
        if spikes_out is not None:
            spikes = spikes_out.copy_(spikes)
        if pkt_out is not None:
            pkt = pkt_out.copy_(pkt)
        return v, spikes, pkt
    if v.device.type != "cuda":
        raise ValueError(f"fused_step runs on cuda or cpu, not {v.device}")
    if spikes_out is not None and spikes_out.data_ptr() == s_prev.data_ptr():
        raise ValueError("spikes_out must not alias s_prev: other blocks "
                         "of the launch still read s_prev")
    b, n_int = v.shape
    if spikes_out is None:
        spikes_out = torch.empty_like(v)
    if pkt_out is None:
        pkt_out = torch.empty((b,), dtype=torch.int32, device=v.device)
    if b and n_int:
        lib = _build.load_library()
        with torch.cuda.device(v.device):
            err = lib.suprasnn_fused_step(
                s_ext.data_ptr(), s_prev.data_ptr(), weight.data_ptr(),
                weight.element_size(), v.data_ptr(), spikes_out.data_ptr(),
                pkt_out.data_ptr(), b, s_ext.shape[1], n_int, p.leak_shift,
                p.v_threshold, p.v_reset,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "fused_step")
        fused_step.launches += 1
    return v, spikes_out, pkt_out


fused_step.launches = 0
