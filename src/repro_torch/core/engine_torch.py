"""Batched executor of lowered SupraSNN programs on one device; port of
``repro/core/engine_jax.py``.

A scheduled program is lowered once (:func:`lower_tables`) and run over
T timesteps with a leading batch dimension. Each timestep is one of
three **kernel tiers**, selected by
:class:`~repro_torch.core.execution.ExecutionSpec`:

* ``"fused"`` (default) — the whole timestep in ONE kernel launch over
  the packed dense weight plane (:mod:`repro_torch.kernels.fused_step`);
* ``"lif"`` — ``index_select`` gather + int32 ``index_add_``
  segment-sum over the op stream, then the LIF kernel, the Neuron Unit
  (:func:`repro_torch.kernels.lif_update.lif_update_int`);
* ``"reference"`` — the same segment-sum + plain torch ``lif_step_int``.

Every tier gives the same bits as the reference engine: each non-NOP op
adds ``weight * spike(pre)`` to its post neuron once per timestep, and
int32 addition is associative, so any summation order gives the same
current (deterministic-commit property, paper §4.2).

The step loop keeps everything on the device: ``ext`` is moved there
once as ``[T, B, n_inputs]``, spikes are written into a ``[T, B, n_int]``
buffer whose slice ``t-1`` is step ``t``'s ``s_prev`` (so a step never
writes the plane it reads, the recurrent race the reference avoids by
concatenating), ``v`` is updated in place, and the results are copied
back once at the end. On the card each kernel tier has a step loop of
its own that launches with no per-step checks or stream lookups, each
step's pointers offsets into the contiguous ``[T, B, ·]`` buffers: the
fused tier packs the plane for its kernel once, at build, and launches
through ``fused_launcher``, one launch per timestep; the ``"lif"`` tier
merges each step into one current plane kept for the whole run, which
its Neuron Unit (``lif_int_launcher``) drains as it reads it. A program
with no internal neurons does no neuron work: there a step's packets
are its non-zero external spikes, counted on the device.

On the card the ``"fused"`` and ``"lif"`` tiers also capture the whole
T-step loop as one CUDA graph per ``(batch, T)`` shape
(:meth:`TorchMappedEngine.precompile`, the counterpart of the
reference's AOT-compiled scan): static buffers for that shape, the
zeroing of the state, the step loop and the packet count, replayed for
every request of the shape. The ``"reference"`` tier and CPU engines
stay eager.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import packet_stats
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling import LoweredProgram, OpTables, lower_tables
from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import (fused_launcher, fused_step,
                                            pack_dense, pack_plane)
from repro_torch.kernels.launches import count_launch, recording
from repro_torch.kernels.lif_update import lif_int_launcher, lif_update_int
from repro_torch.snn.lif import LIFIntParams, lif_step_int


def normalize_ext_spikes(ext_spikes, n_inputs: int
                         ) -> tuple[np.ndarray, bool]:
    """Validate a spike train (batch) into ``[B, T, n_inputs]`` form.

    Returns ``(ext, squeeze)`` where ``squeeze`` records that a 2-D
    ``[T, n_inputs]`` input was promoted and the outputs should drop
    the batch dim again.
    """
    ext = np.asarray(ext_spikes)
    squeeze = ext.ndim == 2
    if squeeze:
        ext = ext[None]
    if ext.ndim != 3 or ext.shape[2] != n_inputs:
        raise ValueError(f"ext_spikes shape {np.shape(ext_spikes)} != "
                         f"[B, T, {n_inputs}] or [T, {n_inputs}]")
    return ext, squeeze


def finalize_outputs(spikes, v, pkts, squeeze: bool
                     ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Host arrays -> the uniform ``(spikes, v_final, stats)`` tuple;
    packet counts widen to int64 as in the reference."""
    spikes = np.ascontiguousarray(spikes, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    pkts = np.ascontiguousarray(pkts, np.int64)
    if squeeze:
        spikes, v, pkts = spikes[0], v[0], pkts[0]
    return spikes, v, packet_stats(pkts)


def _count_packets(ext_d: torch.Tensor, spikes: torch.Tensor,
                   pkts: torch.Tensor) -> None:
    """The distribution phase of a whole run on the device, straight into
    ``pkts`` ``[T, B]``: one MC packet per fired neuron, so step t's are
    ``ext_d[t]``'s non-zero spikes plus ``spikes[t-1]``'s, which are 0/1
    (none with no internal neuron)."""
    torch.sum(ext_d != 0, dim=2, dtype=torch.int32, out=pkts)
    pkts[1:] += spikes[:-1].sum(dim=2, dtype=torch.int32)


@dataclasses.dataclass
class _Buffers:
    """One ``(batch, T)`` shape's device buffers, int32 and contiguous:
    the run's input, outputs and state, and the ``"lif"`` tier's planes
    (``s_all`` = ``ext_d[t] ‖ spikes[t-1]``, ``act`` per op, ``current``
    per neuron). A captured graph keeps its own: the copy width of the
    fused kernel is picked from their addresses at capture, so a graph
    is never replayed over other tensors."""
    ext_d: torch.Tensor                  # [T, B, n_inputs]
    spikes: torch.Tensor                 # [T, B, n_internal]
    pkts: torch.Tensor                   # [T, B]
    v: torch.Tensor                      # [B, n_internal]
    s_prev: torch.Tensor                 # [B, n_internal], zero
    s_all: torch.Tensor | None = None    # [B, n_inputs + n_internal]
    act: torch.Tensor | None = None      # [B, n_ops]
    current: torch.Tensor | None = None  # [B, n_internal]


@dataclasses.dataclass
class _GraphedShape:
    """The T-step loop of one shape captured as a CUDA graph, over its
    static buffers. ``launches`` maps each kernel wrapper to the
    launches the graph recorded: a replay launches them on the card
    without passing through the Python launcher, so :meth:`replay` adds
    them to the wrapper's count."""
    graph: "torch.cuda.CUDAGraph"
    buf: _Buffers
    launches: dict

    def replay(self) -> None:
        self.graph.replay()
        for kernel, n in self.launches.items():
            count_launch(kernel, n)


class TorchMappedEngine:
    """A lowered program placed on one device for batched execution.

    Construction lowers the tables and moves the tier's operands (the
    packed weight plane, or the op stream) to ``spec.device``; ``run``
    then serves any batch of spike trains.
    """

    def __init__(self, g: SNNGraph, tables: OpTables | LoweredProgram,
                 spec: ExecutionSpec | None = None):
        self.spec = as_spec(spec).resolve()
        self.device = torch.device(self.spec.device)
        self.lowered = (tables if isinstance(tables, LoweredProgram)
                        else lower_tables(g, tables))
        self.lif: LIFIntParams = g.lif
        lw, dev = self.lowered, self.device
        self._launch = self._run_card = None
        if self.spec.kernel == "fused":
            self._weight = torch.from_numpy(pack_dense(lw).weight).to(dev)
            if dev.type == "cuda":      # packed and checked once, here
                self._weight = pack_plane(self._weight)
                self._launch = fused_launcher(self._weight, self.lif,
                                              lw.n_inputs)
                self._run_card = self._run_fused
        else:
            self._op_pre = torch.from_numpy(lw.op_pre.astype(np.int64)).to(dev)
            self._op_post = torch.from_numpy(
                lw.op_post_local.astype(np.int64)).to(dev)
            self._op_w = torch.from_numpy(lw.op_weight).to(dev)
            if self.spec.kernel == "lif" and dev.type == "cuda":
                self._launch = lif_int_launcher(self.lif)
                self._run_card = self._run_lif
        self._warm: set[tuple[int, int]] = set()
        self._graphs: dict[tuple[int, int], _GraphedShape] = {}

    # -- one timestep -------------------------------------------------------

    def _step(self, ext_t: torch.Tensor, s_prev: torch.Tensor,
              v: torch.Tensor, s_out: torch.Tensor,
              pkt_out: torch.Tensor) -> None:
        if self.spec.kernel == "fused":
            fused_step(ext_t, s_prev, v, self._weight, self.lif,
                       spikes_out=s_out, pkt_out=pkt_out)
            return
        # distribution phase: one MC packet per fired neuron
        s_all = torch.cat([ext_t, s_prev], dim=1)
        pkt_out.copy_((s_all != 0).sum(dim=1, dtype=torch.int32))
        # synaptic phase: every op gated by its pre's spike, merged per
        # post neuron (exact int32 sum == ME tree)
        act = s_all.index_select(1, self._op_pre) * self._op_w
        current = torch.zeros_like(v).index_add_(1, self._op_post, act)
        # Neuron Unit
        if self.spec.kernel == "lif":
            lif_update_int(v, current, self.lif, out=(v, s_out))
        else:
            v_next, s = lif_step_int(v, current, self.lif)
            v.copy_(v_next)
            s_out.copy_(s)

    def _run_fused(self, buf: _Buffers) -> None:
        """The fused tier's step loop on the card. The buffers were made
        by :meth:`_buffers` (contiguous int32 on the device), which is
        their check; step ``t`` reads ``ext_d[t]`` and ``spikes[t-1]``
        and writes ``spikes[t]`` and ``pkts[t]`` at pointer offsets."""
        t_steps, b, n_in = buf.ext_d.shape
        n_int = buf.v.shape[1]
        launch, dev = self._launch, self.device
        ext0, sp0 = buf.ext_d.data_ptr(), buf.spikes.data_ptr()
        pk0 = buf.pkts.data_ptr()
        d_ext, d_sp, d_pk = b * n_in * 4, b * n_int * 4, b * 4
        v_p, prev = buf.v.data_ptr(), buf.s_prev.data_ptr()
        with _build.on_device(dev):
            stream = _build.stream_handle(dev)
            for t in range(t_steps):
                out = sp0 + t * d_sp
                launch(ext0 + t * d_ext, prev, v_p, out, pk0 + t * d_pk, b,
                       stream)
                prev = out

    def _run_lif(self, buf: _Buffers) -> None:
        """The ``"lif"`` tier's step loop on the card, over the buffers
        of :meth:`_buffers` as :meth:`_run_fused` (``s_prev`` and
        ``current`` are zero). Each step gathers ``ext_d[t] ‖
        spikes[t-1]`` into ``s_all``, merges every op into ``current``
        (the Neuron Unit leaves it zero) and launches the Neuron Unit on
        ``v`` in place, its spikes into ``spikes[t]``. The packets are
        counted once per run, by :func:`_count_packets`."""
        ext_d, spikes, v = buf.ext_d, buf.spikes, buf.v
        s_all, act, current = buf.s_all, buf.act, buf.current
        t_steps, b, _ = ext_d.shape
        n_int = v.shape[1]
        launch, dev, n = self._launch, self.device, b * n_int
        sp0, d_sp = spikes.data_ptr(), b * n_int * 4
        v_p, cur_p = v.data_ptr(), current.data_ptr()
        prev = buf.s_prev
        with _build.on_device(dev):
            stream = _build.stream_handle(dev)
            for t in range(t_steps):
                torch.cat((ext_d[t], prev), dim=1, out=s_all)
                # synaptic phase: every op gated by its pre's spike,
                # merged per post neuron (exact int32 sum == ME tree)
                torch.index_select(s_all, 1, self._op_pre, out=act)
                act.mul_(self._op_w)
                current.index_add_(1, self._op_post, act)
                launch(v_p, cur_p, v_p, sp0 + t * d_sp, n, stream)
                prev = spikes[t]
        _count_packets(ext_d, spikes, buf.pkts)

    # -- the T-step loop ----------------------------------------------------

    def _buffers(self, b: int, t_steps: int) -> _Buffers:
        lw = self.lowered
        i32 = dict(dtype=torch.int32, device=self.device)
        n_in, n_int = lw.n_inputs, lw.n_internal
        buf = _Buffers(torch.empty((t_steps, b, n_in), **i32),
                       torch.empty((t_steps, b, n_int), **i32),
                       torch.empty((t_steps, b), **i32),
                       torch.empty((b, n_int), **i32),
                       torch.empty((b, n_int), **i32))
        if self._run_card == self._run_lif:
            buf.s_all = torch.empty((b, n_in + n_int), **i32)
            buf.act = torch.empty((b, lw.n_ops), **i32)
            buf.current = torch.empty((b, n_int), **i32)
        return buf

    def _loop(self, buf: _Buffers) -> None:
        """One whole run over ``buf``: the state zeroed, T steps, the
        packets counted; what a captured graph replays."""
        buf.v.zero_()
        buf.s_prev.zero_()
        if buf.current is not None:
            buf.current.zero_()
        if self._run_card is None:
            s_prev = buf.s_prev
            for t in range(buf.ext_d.shape[0]):
                self._step(buf.ext_d[t], s_prev, buf.v, buf.spikes[t],
                           buf.pkts[t])
                s_prev = buf.spikes[t]
        elif buf.v.numel():
            self._run_card(buf)
        else:           # no neuron work: the packets are the ext spikes
            _count_packets(buf.ext_d, buf.spikes, buf.pkts)

    def _capture(self, b: int, t_steps: int) -> _GraphedShape:
        """Capture the loop of one shape into a CUDA graph over static
        buffers, after one warm run on a side stream (the first launch
        of a lazily loaded kernel must not fall inside a capture). A
        capture that fails raises. The capture launches nothing: the
        launches it records go to :meth:`_GraphedShape.replay`, not to
        the wrappers' counts."""
        buf = self._buffers(b, t_steps)
        buf.ext_d.zero_()
        with _build.on_device(self.device):
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._loop(buf)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with recording() as recorded, torch.cuda.graph(graph):
                self._loop(buf)
        return _GraphedShape(graph, buf, recorded)

    def precompile(self, batch_sizes, timesteps: int) -> list[tuple[int, int]]:
        """Prepare each ``(batch, timesteps)`` shape for serving.

        On the card the ``"fused"`` and ``"lif"`` tiers capture the
        shape's whole loop as one CUDA graph, which :meth:`run` replays
        for a request of that shape; elsewhere the shape is run once on
        zeros (builds the kernels' library, warms the allocator).
        Returns the shapes prepared by THIS call.
        """
        done = []
        for b in batch_sizes:
            key = (int(b), int(timesteps))
            if key in self._warm:
                continue
            if self._run_card is not None:
                self._graphs[key] = self._capture(*key)
            else:
                self.run(np.zeros((key[0], key[1], self.lowered.n_inputs),
                                  np.int32))
            self._warm.add(key)
            done.append(key)
        return done

    # -- public API ---------------------------------------------------------

    def run(self, ext_spikes: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Execute the program on ``ext_spikes``.

        ext_spikes: [T, n_inputs] or batched [B, T, n_inputs].
        Returns (spikes, v_final, stats): [T, n_int] / [n_int] /
        packet_counts [T] for 2-D input, with a leading B when batched.
        A shape :meth:`precompile` captured replays its graph over its
        static buffers (so one engine serves one request at a time);
        any other runs the loop eagerly.
        """
        ext, squeeze = normalize_ext_spikes(ext_spikes, self.lowered.n_inputs)
        b, t_steps, _ = ext.shape
        host = torch.from_numpy(np.ascontiguousarray(ext.transpose(1, 0, 2),
                                                     np.int32))
        graphed = self._graphs.get((b, t_steps))
        if graphed is not None:
            buf = graphed.buf
            buf.ext_d.copy_(host)
            graphed.replay()
        else:
            buf = self._buffers(b, t_steps)
            buf.ext_d.copy_(host)
            self._loop(buf)
        return finalize_outputs(buf.spikes.cpu().numpy().transpose(1, 0, 2),
                                buf.v.cpu().numpy(), buf.pkts.cpu().numpy().T,
                                squeeze)
