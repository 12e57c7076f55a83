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
on the H100 are noted in the source. The kernel takes the plane packed
for its tensor cores (:func:`pack_plane`: transposed, padded, an int16
plane split into bytes); the engine packs once at build and launches
through :func:`fused_launcher`, which checks nothing per step.
:func:`fused_step_emulated` replays the kernel's decomposition in plain
torch for the tests.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.analysis.ranges import dense_plane_bounds, min_safe_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.contract import KSTEP, kstep_ranges
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


@dataclasses.dataclass(frozen=True)
class PackedPlane:
    """A dense plane ``W [n_all, n_int]`` packed for ``csrc/fused_step.cu``.

    ``planes`` are ``[m_pad, k_pad]`` row-major, K-contiguous (``W^T``),
    zero-padded to multiples of 16 post (M) and 32 pre (K) neurons: an
    int8 plane as itself, an int16 plane as ``lo = W & 0xFF`` (uint8)
    and ``hi = W >> 8`` (int8) with ``W = 256 * hi + lo``, an int32 plane
    as itself. ``kind`` is the dense plane's element size (1, 2 or 4).
    """
    planes: tuple[torch.Tensor, ...]
    kind: int
    n_all: int
    n_int: int

    @property
    def m_pad(self) -> int:
        return self.planes[0].shape[0]

    @property
    def k_pad(self) -> int:
        return self.planes[0].shape[1]

    @property
    def device(self) -> torch.device:
        return self.planes[0].device


def pack_plane(weight: torch.Tensor) -> PackedPlane:
    """Pack a dense int8/int16/int32 plane for the kernel, on its device."""
    if weight.ndim != 2 or weight.dtype not in _PLANE_DTYPES:
        raise ValueError(f"weight {weight.dtype} {tuple(weight.shape)}: want "
                         f"a 2-D plane of {_PLANE_DTYPES}")
    n_all, n_int = weight.shape
    wt = torch.nn.functional.pad(weight.t(), (0, -n_all % KSTEP,
                                              0, -n_int % 16))
    if weight.dtype == torch.int16:
        planes = ((wt & 0xFF).to(torch.uint8), (wt >> 8).to(torch.int8))
    else:
        planes = (wt,)
    return PackedPlane(tuple(t.contiguous() for t in planes),
                       weight.element_size(), n_all, n_int)


def unpack_plane(packed: PackedPlane) -> torch.Tensor:
    """The dense plane a :class:`PackedPlane` was packed from."""
    if packed.kind == 2:
        lo, hi = (t.to(torch.int32) for t in packed.planes)
        wt = (hi * 256 + lo).to(torch.int16)
    else:
        wt = packed.planes[0]
    return wt[:packed.n_int, :packed.n_all].t().contiguous()


def fused_step_emulated(s_ext: torch.Tensor, s_prev: torch.Tensor,
                        v: torch.Tensor, packed: PackedPlane,
                        p: LIFIntParams
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``csrc/fused_step.cu``'s decomposition replayed in plain torch, for
    the tests: ``(v_next, spikes, packet_counts)`` as new tensors.

    Per tile of 8 batch rows: the pre axis in K-steps of 32 split over
    ``cluster_split`` ranks; a K-step whose spikes are all zero in the
    tile's rows is skipped; a K-step holding a spike outside {0, 1}, and
    every K-step of an int32 plane, takes exact integer products;
    otherwise an int8 plane takes one byte product and an int16 plane
    ``256 * (s @ hi) + s @ lo``. Each rank's partial tile wraps in
    uint32 and the ranks are added in rank order, as are their packet
    counts; then the integer LIF epilogue.
    """
    s_all = torch.cat([s_ext, s_prev], 1).to(torch.int64)
    b, n_all = s_all.shape
    s_all = torch.nn.functional.pad(s_all, (0, packed.k_pad - n_all,
                                            0, -b % 8))
    planes = [t.to(torch.int64) for t in packed.planes]
    dense = (planes[1] * 256 + planes[0] if packed.kind == 2 else planes[0])
    mask = 2 ** 32 - 1
    current = torch.zeros((s_all.shape[0], packed.m_pad), dtype=torch.int64)
    pkt = torch.zeros((s_all.shape[0],), dtype=torch.int64)
    for b0 in range(0, s_all.shape[0], 8):
        rows = s_all[b0:b0 + 8]
        total = torch.zeros((8, packed.m_pad), dtype=torch.int64)
        for k0, k1 in kstep_ranges(packed.k_pad // KSTEP):
            part = torch.zeros_like(total)
            for ks in range(k0, k1):
                cols = slice(ks * KSTEP, (ks + 1) * KSTEP)
                s = rows[:, cols]
                if not s.any():
                    continue                    # the MC-tree skip
                if packed.kind == 4 or ((s != 0) & (s != 1)).any():
                    part += s @ dense[:, cols].t()
                elif packed.kind == 2:
                    part += 256 * (s @ planes[1][:, cols].t()) \
                        + s @ planes[0][:, cols].t()
                else:
                    part += s @ planes[0][:, cols].t()
            total = (total + (part & mask)) & mask
            pkt[b0:b0 + 8] += (rows[:, k0 * KSTEP:k1 * KSTEP] != 0).sum(1)
        current[b0:b0 + 8] = total
    current = current[:b, :packed.n_int]
    current = torch.where(current >= 2 ** 31, current - 2 ** 32, current)
    v_next, spikes = lif_step_int(v, current.to(torch.int32), p)
    return v_next, spikes, pkt[:b].to(torch.int32)


def _check_args(s_ext, s_prev, v, weight, p, spikes_out, pkt_out) -> None:
    """Raise on operands the kernel does not take. A public call pays
    this every step, so each tensor costs a few attribute reads."""
    if v.ndim != 2 or s_ext.ndim != 2:
        raise ValueError(f"v {tuple(v.shape)} and s_ext "
                         f"{tuple(s_ext.shape)} must be 2-D")
    if isinstance(weight, PackedPlane):
        w0 = weight.planes[0]
        n_rows = (weight.n_all, weight.n_int)
        w_dtype = _PLANE_DTYPES[weight.kind // 2]
    else:
        w0, n_rows, w_dtype = weight, tuple(weight.shape), weight.dtype
    i32, shape = torch.int32, v.shape
    dev, cuda = v.get_device(), v.is_cuda
    for name, t, want, dtype in (
            ("s_ext", s_ext, (shape[0], s_ext.shape[1]), i32),
            ("s_prev", s_prev, shape, i32), ("v", v, shape, i32),
            ("spikes_out", spikes_out, shape, i32),
            ("pkt_out", pkt_out, shape[:1], i32),
            ("weight", w0, w0.shape, w0.dtype)):
        if t is None:
            continue
        if t.get_device() != dev or t.is_cuda != cuda:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if t.shape != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(want)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_rows != (s_ext.shape[1] + shape[1], shape[1]):
        raise ValueError(f"weight shape {n_rows} != "
                         f"{(s_ext.shape[1] + shape[1], shape[1])}")
    if w_dtype not in _PLANE_DTYPES:
        raise ValueError(f"weight dtype {w_dtype} not in {_PLANE_DTYPES}")
    check_params(p)


def fused_launcher(packed: PackedPlane, p: LIFIntParams, n_ext: int):
    """An unchecked launch of ``csrc/fused_step.cu`` for operands checked
    once: the engine's path. Returns ``launch(ext, s_prev, v, s_next,
    pkt, batch, stream)`` over raw pointers (ints) of contiguous int32
    buffers ``ext [batch, n_ext]``, ``s_prev``/``v``/``s_next [batch,
    n_int]`` and ``pkt [batch]`` on ``packed``'s device (``batch >= 1``)
    and a raw stream handle; the caller is on that device. Each launch
    counts in ``fused_step.launches``."""
    check_params(p)
    if packed.n_all != n_ext + packed.n_int:
        raise ValueError(f"plane of {packed.n_all} pre neurons, want "
                         f"{n_ext} + {packed.n_int}")
    fn = _build.load_library().suprasnn_fused_step
    p0, p1 = packed.planes[0].data_ptr(), packed.planes[-1].data_ptr()
    kind, n_int, k_pad = packed.kind, packed.n_int, packed.k_pad
    ls, th, reset = p.leak_shift, p.v_threshold, p.v_reset

    def launch(ext, s_prev, v, s_next, pkt, batch, stream, _keep=packed):
        err = fn(ext, s_prev, p0, p1, kind, v, s_next, pkt, batch, n_ext,
                 n_int, k_pad, ls, th, reset, stream)
        _build.check(err, "fused_step")
        fused_step.launches += 1

    return launch


def fused_step(s_ext: torch.Tensor, s_prev: torch.Tensor, v: torch.Tensor,
               weight: torch.Tensor | PackedPlane, p: LIFIntParams, *,
               spikes_out: torch.Tensor | None = None,
               pkt_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused timestep: ``(v, spikes, packet_counts)``.

    s_ext:  [B, n_ext] int32 external spikes of this step (any values).
    s_prev: [B, n_int] int32 internal spikes of the previous step; the
            pre axis of ``weight`` is ``s_ext``'s columns, then these.
    v:      [B, n_int] int32 membrane state, updated in place (as the
            reference aliases it onto ``v_next``) and returned.
    weight: [n_ext + n_int, n_int] int8/int16/int32 dense plane
            (:func:`pack_dense`), accumulated in int32, or that plane
            packed by :func:`pack_plane` on ``v``'s device (a raw plane
            is packed per call on CUDA).
    spikes_out [B, n_int] / pkt_out [B] (int32): where to write the
            spikes and packet counts; allocated when not given.
            ``spikes_out`` must not be ``s_prev``.

    CUDA tensors launch ``csrc/fused_step.cu`` (counted in
    ``fused_step.launches``); CPU tensors run :func:`fused_step_ref`.
    """
    _check_args(s_ext, s_prev, v, weight, p, spikes_out, pkt_out)
    packed = weight if isinstance(weight, PackedPlane) else None
    dev = v.device
    if dev.type == "cpu":
        dense = unpack_plane(packed) if packed is not None else weight
        v_next, spikes, pkt = fused_step_ref(s_ext, s_prev, v, dense, p)
        v.copy_(v_next)
        if spikes_out is not None:
            spikes = spikes_out.copy_(spikes)
        if pkt_out is not None:
            pkt = pkt_out.copy_(pkt)
        return v, spikes, pkt
    if dev.type != "cuda":
        raise ValueError(f"fused_step runs on cuda or cpu, not {dev}")
    if spikes_out is not None and spikes_out.data_ptr() == s_prev.data_ptr():
        raise ValueError("spikes_out must not alias s_prev: other blocks "
                         "of the launch still read s_prev")
    b, n_int = v.shape
    if spikes_out is None:
        spikes_out = torch.empty_like(v)
    if pkt_out is None:
        pkt_out = v.new_empty((b,))
    if b and n_int:
        if packed is None:
            packed = pack_plane(weight)
        with _build.on_device(dev):
            err = _build.load_library().suprasnn_fused_step(
                s_ext.data_ptr(), s_prev.data_ptr(),
                packed.planes[0].data_ptr(), packed.planes[-1].data_ptr(),
                packed.kind, v.data_ptr(), spikes_out.data_ptr(),
                pkt_out.data_ptr(), b, s_ext.shape[1], n_int, packed.k_pad,
                p.leak_shift, p.v_threshold, p.v_reset,
                _build.stream_handle(dev))
        _build.check(err, "fused_step")
        fused_step.launches += 1
    elif b:     # no internal neuron: the packets are the external spikes
        torch.sum(s_ext != 0, dim=1, dtype=torch.int32, out=pkt_out)
    return v, spikes_out, pkt_out


fused_step.launches = 0
