"""Batched executor of lowered SupraSNN programs on one device; port of
``repro/core/engine_jax.py``.

A scheduled program is lowered once (:func:`lower_tables`) and run over
T timesteps with a leading batch dimension. Each timestep is one of
three **kernel tiers**, selected by
:class:`~repro_torch.core.execution.ExecutionSpec`:

* ``"fused"`` (default) — the whole timestep in ONE kernel launch over
  the packed dense weight plane (:mod:`repro_torch.kernels.fused_step`);
* ``"lif"`` — ``index_select`` gather + int32 ``index_add_``
  segment-sum over the op stream, then the LIF kernel
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
back once at the end. The fused tier launches one kernel per timestep.
On the card it packs the plane for the kernel once, at build, and the
step loop launches through ``fused_launcher`` with no per-step checks,
views or stream lookups: each step's pointers are offsets into the
contiguous ``[T, B, ·]`` buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import packet_stats
from repro_torch.core.execution import ExecutionSpec, as_spec
from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling import LoweredProgram, OpTables, lower_tables
from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import (fused_launcher, fused_step,
                                            pack_dense, pack_plane)
from repro_torch.kernels.lif_update import lif_update_int
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
        self._launch = None
        if self.spec.kernel == "fused":
            self._weight = torch.from_numpy(pack_dense(lw).weight).to(dev)
            if dev.type == "cuda":      # packed and checked once, here
                self._weight = pack_plane(self._weight)
                self._launch = fused_launcher(self._weight, self.lif,
                                              lw.n_inputs)
        else:
            self._op_pre = torch.from_numpy(lw.op_pre.astype(np.int64)).to(dev)
            self._op_post = torch.from_numpy(
                lw.op_post_local.astype(np.int64)).to(dev)
            self._op_w = torch.from_numpy(lw.op_weight).to(dev)
        self._warm: set[tuple[int, int]] = set()

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

    def _run_fused(self, ext_d: torch.Tensor, s_prev: torch.Tensor,
                   v: torch.Tensor, spikes: torch.Tensor,
                   pkts: torch.Tensor) -> None:
        """The fused tier's step loop on the card. The buffers were made
        by ``run`` (contiguous int32 on the device, ``[T, B, ·]``), which
        is their check; step ``t`` reads ``ext_d[t]`` and ``spikes[t-1]``
        and writes ``spikes[t]`` and ``pkts[t]`` at pointer offsets."""
        t_steps, b, n_in = ext_d.shape
        n_int = v.shape[1]
        launch, dev = self._launch, self.device
        ext0, sp0, pk0 = ext_d.data_ptr(), spikes.data_ptr(), pkts.data_ptr()
        d_ext, d_sp, d_pk = b * n_in * 4, b * n_int * 4, b * 4
        v_p, prev = v.data_ptr(), s_prev.data_ptr()
        with _build.on_device(dev):
            stream = _build.stream_handle(dev)
            for t in range(t_steps):
                out = sp0 + t * d_sp
                launch(ext0 + t * d_ext, prev, v_p, out, pk0 + t * d_pk, b,
                       stream)
                prev = out

    # -- warm-up ------------------------------------------------------------

    def precompile(self, batch_sizes, timesteps: int) -> list[tuple[int, int]]:
        """Run each ``(batch, timesteps)`` shape once on zeros.

        Builds the kernels' library on first use and warms the
        allocator, so a warmed shape's first real request runs at
        steady-state latency. Returns the shapes warmed by THIS call.
        """
        warmed = []
        for b in batch_sizes:
            key = (int(b), int(timesteps))
            if key in self._warm:
                continue
            self.run(np.zeros((key[0], key[1], self.lowered.n_inputs),
                              np.int32))
            self._warm.add(key)
            warmed.append(key)
        return warmed

    # -- public API ---------------------------------------------------------

    def run(self, ext_spikes: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Execute the program on ``ext_spikes``.

        ext_spikes: [T, n_inputs] or batched [B, T, n_inputs].
        Returns (spikes, v_final, stats): [T, n_int] / [n_int] /
        packet_counts [T] for 2-D input, with a leading B when batched.
        """
        lw, dev = self.lowered, self.device
        ext, squeeze = normalize_ext_spikes(ext_spikes, lw.n_inputs)
        b, t_steps, _ = ext.shape
        ext_d = torch.from_numpy(np.ascontiguousarray(
            ext.transpose(1, 0, 2), np.int32)).to(dev)
        spikes = torch.empty((t_steps, b, lw.n_internal), dtype=torch.int32,
                             device=dev)
        pkts = torch.empty((t_steps, b), dtype=torch.int32, device=dev)
        v = torch.zeros((b, lw.n_internal), dtype=torch.int32, device=dev)
        s_prev = torch.zeros_like(v)
        if self._launch is not None:
            if b and lw.n_internal:
                self._run_fused(ext_d, s_prev, v, spikes, pkts)
        else:
            for t in range(t_steps):
                self._step(ext_d[t], s_prev, v, spikes[t], pkts[t])
                s_prev = spikes[t]
        return finalize_outputs(spikes.cpu().numpy().transpose(1, 0, 2),
                                v.cpu().numpy(), pkts.cpu().numpy().T,
                                squeeze)
