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

:func:`fused_run` runs all T steps of a run, from zero state, in one
launch of ``csrc/fused_run.cu`` (the counterpart of the reference's
compiled scan over ``fused_step``), with :func:`fused_run_ref` (a loop
of :func:`fused_step_ref`) as its plain version and
:func:`fused_run_emulated` replaying its decomposition. It holds a
cluster's share of the packed plane in shared memory for the whole run,
so it takes only a plane that fits: :func:`fused_path` is the shape
rule ("run" or "step"), decided on the card by the kernel's own plan
(``suprasnn_fused_run_plan``) and mirrored here by
:func:`run_smem_bytes`. The engine launches through
:func:`fused_run_launcher` where the rule says "run", and steps through
:func:`fused_launcher` where it says "step".
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from repro_torch.analysis.ranges import dense_plane_bounds, min_safe_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.contract import KSTEP, MAX_CLUSTER, kstep_ranges
from repro_torch.kernels.launches import count_launch
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
        count_launch(fused_step)

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
        count_launch(fused_step)
    elif b:     # no internal neuron: the packets are the external spikes
        torch.sum(s_ext != 0, dim=1, dtype=torch.int32, out=pkt_out)
    return v, spikes_out, pkt_out


fused_step.launches = 0


# -- the whole run in one launch (csrc/fused_run.cu) -------------------------

RUN_TILE = 16              # post neurons per tile (one m16)
RUN_ROWS = 8               # batch rows per cluster (one n8)
RUN_WARPS = 16             # warp w takes K-steps w, w + 16, ...
RUN_SMEM_LIMIT = 232448    # a CTA's shared memory on Hopper, bytes


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def run_split(m_tiles: int) -> int:
    """How many CTAs of a cluster split ``m_tiles`` post tiles."""
    return min(max(m_tiles, 1), MAX_CLUSTER)


def run_tiles(m_tiles: int) -> list[tuple[int, int]]:
    """Each rank's post tiles ``[begin, end)``, in rank order."""
    n = run_split(m_tiles)
    bounds = [r * m_tiles // n for r in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def run_smem_bytes(kind: int, n_ext: int, n_int: int) -> int:
    """The dynamic shared memory one CTA of ``csrc/fused_run.cu`` takes
    for a plane of element size ``kind`` (1, 2, 4) over ``n_ext`` external
    and ``n_int`` internal neurons: its rows of the packed plane, two
    internal spike rows of the cluster's 8 batch rows as bytes, two
    staged ``ext`` rows as int32, the warps' partial currents, ``v``,
    packet counts and a step's spike words. Mirrors the source's
    ``run_layout``."""
    k_pad = -(-(n_ext + n_int) // KSTEP) * KSTEP
    m_tiles = -(-n_int // RUN_TILE)
    tiles = -(-m_tiles // run_split(m_tiles))
    w_ld = k_pad + 4 if kind == 4 else k_pad + 16
    w_bytes = _round16(tiles * RUN_TILE * w_ld * (4 if kind == 4 else 1))
    i_ld = _round16(max(k_pad - n_ext, m_tiles * RUN_TILE)) + 16
    return (w_bytes * (2 if kind == 2 else 1)
            + _round16(2 * RUN_ROWS * i_ld)
            + _round16(2 * RUN_ROWS * -(-n_ext // 4) * 4 * 4)
            + _round16(RUN_WARPS * tiles * RUN_ROWS * RUN_TILE * 4)
            + _round16(RUN_ROWS * tiles * RUN_TILE * 4)
            + _round16(RUN_WARPS * RUN_ROWS * 4)
            + _round16(RUN_ROWS * tiles * RUN_TILE))


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """``suprasnn_fused_run_plan``'s answer for a packed plane: a CTA's
    shared memory, the CTAs of a cluster, and how many such clusters the
    card holds at once (0: the plane does not fit)."""
    smem_bytes: int
    n_split: int
    clusters: int


def fused_run_plan(packed: PackedPlane) -> RunPlan:
    """The run kernel's plan for ``packed`` (on a CUDA device), from the
    kernel's library; raises if the plan and :func:`run_smem_bytes`
    disagree (the mirror is out of date)."""
    out = (ctypes.c_int * 3)()
    n_ext = packed.n_all - packed.n_int
    with _build.on_device(packed.device):
        err = _build.load_library().suprasnn_fused_run_plan(
            packed.kind, n_ext, packed.k_pad, packed.m_pad, out)
    _build.check(err, "fused_run plan")
    plan = RunPlan(*out)
    mirror = run_smem_bytes(packed.kind, n_ext, packed.n_int)
    if plan.smem_bytes != mirror:
        raise RuntimeError(f"fused_run: the kernel's layout takes "
                           f"{plan.smem_bytes} bytes, run_smem_bytes says "
                           f"{mirror}")
    return plan


def fused_path(weight: torch.Tensor | PackedPlane, n_ext: int) -> str:
    """The shape rule: ``"run"`` where :func:`fused_run` takes the plane
    (a whole run in one launch), ``"step"`` where it does not (one
    :func:`fused_step` a step). For a plane packed on a CUDA device the
    kernel's own plan decides: its layout within a CTA's shared memory
    and ``cudaOccupancyMaxActiveClusters`` at least 1. Elsewhere
    :func:`run_smem_bytes` within ``RUN_SMEM_LIMIT``. A plane with no
    internal neuron has no neuron work: ``"step"``."""
    if isinstance(weight, PackedPlane):
        kind, n_int = weight.kind, weight.n_int
    else:
        kind, n_int = weight.element_size(), weight.shape[1]
    if n_int == 0:
        return "step"
    if isinstance(weight, PackedPlane) and weight.device.type == "cuda":
        return "run" if fused_run_plan(weight).clusters >= 1 else "step"
    return ("run" if run_smem_bytes(kind, n_ext, n_int) <= RUN_SMEM_LIMIT
            else "step")


def fused_run_ref(ext: torch.Tensor, weight: torch.Tensor, p: LIFIntParams
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fused_run`: :func:`fused_step_ref`
    over the T steps of ``ext`` ``[T, B, n_ext]`` from ``v = 0`` and
    ``s[-1] = 0``. Returns ``(spikes [T, B, n_int], v_final [B, n_int],
    packet_counts [T, B])``."""
    t_steps, b, _ = ext.shape
    n_int = weight.shape[1]
    v = ext.new_zeros((b, n_int))
    s = ext.new_zeros((b, n_int))
    spikes, pkts = [], []
    for t in range(t_steps):
        v, s, pkt = fused_step_ref(ext[t], s, v, weight, p)
        spikes.append(s)
        pkts.append(pkt)
    if not t_steps:
        return (ext.new_zeros((0, b, n_int)), v, ext.new_zeros((0, b)))
    return torch.stack(spikes), v, torch.stack(pkts)


def fused_run_emulated(ext: torch.Tensor, packed: PackedPlane,
                       p: LIFIntParams
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``csrc/fused_run.cu``'s decomposition replayed in plain torch, for
    the tests: ``(spikes, v_final, packet_counts)`` as :func:`fused_run_ref`.

    Per tile of 8 batch rows and per step: the post axis in tiles of 16
    split over ``run_split`` ranks (``run_tiles``), each rank's current
    whole over K; warp w takes the K-steps w, w + 16, ...; a K-step whose
    spikes are all zero in the tile's rows is skipped; a K-step holding
    a spike outside {0, 1}, and every K-step of an int32 plane, takes
    exact integer products; otherwise an int8 plane takes one byte
    product and an int16 plane ``256 * (s @ hi) + s @ lo``. Each warp's
    partial wraps in uint32 and the warps are added in order, as are
    their packet counts; then the integer LIF epilogue. A row past the
    batch spikes nothing into the spike rows."""
    t_steps, b, n_ext = ext.shape
    n_int, k_pad = packed.n_int, packed.k_pad
    planes = [t.to(torch.int64) for t in packed.planes]
    dense = planes[1] * 256 + planes[0] if packed.kind == 2 else planes[0]
    n_ks, mask = k_pad // KSTEP, 2 ** 32 - 1
    ranks = run_tiles(packed.m_pad // RUN_TILE)
    spikes = torch.zeros((t_steps, b, n_int), dtype=torch.int32)
    pkts = torch.zeros((t_steps, b), dtype=torch.int32)
    v_final = torch.zeros((b, n_int), dtype=torch.int32)
    for b0 in range(0, b, RUN_ROWS):
        rows = min(RUN_ROWS, b - b0)
        v = torch.zeros((RUN_ROWS, packed.m_pad), dtype=torch.int32)
        s_prev = torch.zeros((RUN_ROWS, n_int), dtype=torch.int64)
        for t in range(t_steps):
            s_all = torch.zeros((RUN_ROWS, k_pad), dtype=torch.int64)
            s_all[:rows, :n_ext] = ext[t, b0:b0 + rows].to(torch.int64)
            s_all[:, n_ext:n_ext + n_int] = s_prev
            current = torch.zeros((RUN_ROWS, packed.m_pad), dtype=torch.int64)
            nnz = (s_all != 0).unflatten(1, (n_ks, KSTEP)).sum(2)
            pkt = sum(nnz[:, w::RUN_WARPS].sum(1) for w in range(RUN_WARPS))
            for tile0, tile1 in ranks:
                posts = slice(tile0 * RUN_TILE, tile1 * RUN_TILE)
                total = torch.zeros((RUN_ROWS, tile1 * RUN_TILE
                                     - tile0 * RUN_TILE), dtype=torch.int64)
                for w in range(RUN_WARPS):
                    part = torch.zeros_like(total)
                    for ks in range(w, n_ks, RUN_WARPS):
                        cols = slice(ks * KSTEP, (ks + 1) * KSTEP)
                        s = s_all[:, cols]
                        if not s.any():
                            continue                # the MC-tree skip
                        if packed.kind == 4 or ((s != 0) & (s != 1)).any():
                            part += s @ dense[posts, cols].t()
                        elif packed.kind == 2:
                            part += 256 * (s @ planes[1][posts, cols].t()) \
                                + s @ planes[0][posts, cols].t()
                        else:
                            part += s @ planes[0][posts, cols].t()
                    total = (total + (part & mask)) & mask
                current[:, posts] = total
            current = torch.where(current >= 2 ** 31, current - 2 ** 32,
                                  current).to(torch.int32)
            v, s = lif_step_int(v, current, p)
            s[rows:] = 0                            # rows past the batch
            s_prev = s[:, :n_int].to(torch.int64)
            spikes[t, b0:b0 + rows] = s[:rows, :n_int]
            pkts[t, b0:b0 + rows] = pkt[:rows].to(torch.int32)
        v_final[b0:b0 + rows] = v[:rows, :n_int]
    return spikes, v_final, pkts


def _check_run_args(ext, weight, p, spikes_out, v_out, pkt_out) -> None:
    """Raise on operands the run kernel does not take."""
    if ext.ndim != 3:
        raise ValueError(f"ext {tuple(ext.shape)} must be [T, B, n_ext]")
    t_steps, b, n_ext = ext.shape
    if isinstance(weight, PackedPlane):
        w0, n_rows = weight.planes[0], (weight.n_all, weight.n_int)
        w_dtype = _PLANE_DTYPES[weight.kind // 2]
    else:
        w0, n_rows, w_dtype = weight, tuple(weight.shape), weight.dtype
    if len(n_rows) != 2 or w_dtype not in _PLANE_DTYPES:
        raise ValueError(f"weight {w_dtype} {n_rows}: want a 2-D plane of "
                         f"{_PLANE_DTYPES}")
    n_int = n_rows[1]
    if n_rows[0] != n_ext + n_int:
        raise ValueError(f"weight shape {n_rows} != {(n_ext + n_int, n_int)}")
    for name, t, want in (("ext", ext, ext.shape), ("weight", w0, w0.shape),
                          ("spikes_out", spikes_out, (t_steps, b, n_int)),
                          ("v_out", v_out, (b, n_int)),
                          ("pkt_out", pkt_out, (t_steps, b))):
        if t is None:
            continue
        if t.device != ext.device:
            raise ValueError(f"{name} is on {t.device}, ext on {ext.device}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(want)}")
        if t is not w0 and t.dtype != torch.int32:
            raise ValueError(f"{name} dtype {t.dtype} != torch.int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_params(p)


def fused_run_launcher(packed: PackedPlane, p: LIFIntParams, n_ext: int):
    """An unchecked launch of ``csrc/fused_run.cu`` for a plane that
    :func:`fused_path` gave ``"run"``: the engine's path. Returns
    ``launch(ext, v, spikes, pkt, batch, t_steps, stream)`` over raw
    pointers (ints) of contiguous int32 buffers ``ext [t_steps, batch,
    n_ext]``, ``v [batch, n_int]`` (v_final, written), ``spikes
    [t_steps, batch, n_int]`` and ``pkt [t_steps, batch]`` on
    ``packed``'s device (``batch >= 1``; ``t_steps == 0`` writes
    ``v = 0``) and a raw stream handle; the caller is on that device.
    Each launch counts in ``fused_run.launches``."""
    check_params(p)
    if packed.n_all != n_ext + packed.n_int:
        raise ValueError(f"plane of {packed.n_all} pre neurons, want "
                         f"{n_ext} + {packed.n_int}")
    if fused_path(packed, n_ext) != "run":
        raise ValueError(f"fused_run: a {packed.kind}-byte plane of "
                         f"{packed.n_all} x {packed.n_int} does not fit a "
                         f"cluster's shared memory; step with fused_step")
    fn = _build.load_library().suprasnn_fused_run
    p0, p1 = packed.planes[0].data_ptr(), packed.planes[-1].data_ptr()
    kind, n_int = packed.kind, packed.n_int
    k_pad, m_pad = packed.k_pad, packed.m_pad
    ls, th, reset = p.leak_shift, p.v_threshold, p.v_reset

    def launch(ext, v, spikes, pkt, batch, t_steps, stream, _keep=packed):
        err = fn(ext, p0, p1, kind, v, spikes, pkt, batch, t_steps, n_ext,
                 n_int, k_pad, m_pad, ls, th, reset, stream)
        _build.check(err, "fused_run")
        count_launch(fused_run)

    return launch


def fused_run(ext: torch.Tensor, weight: torch.Tensor | PackedPlane,
              p: LIFIntParams, *, spikes_out: torch.Tensor | None = None,
              v_out: torch.Tensor | None = None,
              pkt_out: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole run from zero state: ``(spikes, v_final, packet_counts)``.

    ext:    [T, B, n_ext] int32 external spikes (any values).
    weight: [n_ext + n_int, n_int] int8/int16/int32 dense plane
            (:func:`pack_dense`), or that plane packed by
            :func:`pack_plane` on ``ext``'s device (a raw plane is packed
            per call on CUDA).
    spikes_out [T, B, n_int] / v_out [B, n_int] / pkt_out [T, B]
            (int32): where to write the results; allocated when not
            given.

    CUDA tensors launch ``csrc/fused_run.cu`` once (counted in
    ``fused_run.launches``) and raise where :func:`fused_path` says the
    plane does not fit; CPU tensors run :func:`fused_run_ref`.
    """
    _check_run_args(ext, weight, p, spikes_out, v_out, pkt_out)
    packed = weight if isinstance(weight, PackedPlane) else None
    t_steps, b, n_ext = ext.shape
    dev = ext.device
    if dev.type == "cpu":
        dense = unpack_plane(packed) if packed is not None else weight
        got = fused_run_ref(ext, dense, p)
        outs = (spikes_out, v_out, pkt_out)
        return tuple(o.copy_(g) if o is not None else g
                     for o, g in zip(outs, got))
    if dev.type != "cuda":
        raise ValueError(f"fused_run runs on cuda or cpu, not {dev}")
    if packed is None:
        packed = pack_plane(weight)
    n_int = packed.n_int
    if spikes_out is None:
        spikes_out = ext.new_empty((t_steps, b, n_int))
    if v_out is None:
        v_out = ext.new_empty((b, n_int))
    if pkt_out is None:
        pkt_out = ext.new_empty((t_steps, b))
    if b and t_steps and n_int:
        launch = fused_run_launcher(packed, p, n_ext)
        with _build.on_device(dev):
            launch(ext.data_ptr(), v_out.data_ptr(), spikes_out.data_ptr(),
                   pkt_out.data_ptr(), b, t_steps, _build.stream_handle(dev))
    else:       # no neuron work: the packets are the external spikes
        v_out.zero_()
        spikes_out.zero_()
        torch.sum(ext != 0, dim=2, dtype=torch.int32, out=pkt_out)
    return spikes_out, v_out, pkt_out


fused_run.launches = 0
