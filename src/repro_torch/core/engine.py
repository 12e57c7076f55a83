"""SupraSNN executors and the cycle/energy model; port of
``repro/core/engine.py``.

* :func:`run_oracle` — the dense integer LIF with the hardware's delayed
  semantics, in torch on a given device (the card unless the caller
  asks for the CPU), the whole batch at once;
* :func:`run_mapped` — the structure-faithful simulator of the mapped
  program (OpTables): per-SPU Spike Memory set/clear, per-SPU partial
  currents, the ME-tree slot-alignment check and the per-neuron Neuron
  Unit. It models SRAMs slot by slot, so it is host code: numpy, as in
  the reference;
* :class:`CycleModel` — the cycle count of the same execution
  (MC-tree distribution + 2 cycles per OT slot + ME/NU drain) and, with
  :class:`PowerModel`, the latency and energy per inference of the FPGA
  design (paper Tables 2/3). These are modeled FPGA figures, not times
  of the card.

Every executor gives the same bits (the paper's deterministic-commit
property). Hardware semantics (paper §4.2): spikes generated in
timestep t-1 are distributed at the start of timestep t; external input
spikes for timestep t arrive in the same window.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling import NOP, OpTables
from repro_torch.snn.lif import LIFIntParams, lif_step_int


def packet_stats(pkt_counts: np.ndarray) -> dict:
    """Per-run stats dict shared by every executor."""
    return {"packet_counts": pkt_counts,
            "mean_packets_per_step": float(pkt_counts.mean())}


def oracle_packet_counts(ext_spikes: np.ndarray, spikes: np.ndarray
                         ) -> np.ndarray:
    """Per-timestep MC packet counts implied by a dense (oracle) run.

    The distribution phase of timestep t carries one packet per neuron
    that fired: external inputs of t plus internal spikes of t-1
    (``run_mapped`` counts exactly this set). Accepts ``[T, n]`` inputs
    (returning ``[T]`` counts) or batched ``[B, T, n]`` (``[B, T]``).
    """
    ext = np.asarray(ext_spikes)
    s = np.asarray(spikes)
    if ext.ndim not in (2, 3) or s.ndim != ext.ndim:
        raise ValueError(f"expected matching [T, n] or [B, T, n] arrays; "
                         f"got {ext.shape} and {s.shape}")
    pkts = np.count_nonzero(ext, axis=-1).astype(np.int64)
    pkts[..., 1:] += np.count_nonzero(s[..., :-1, :], axis=-1)
    return pkts


# ---------------------------------------------------------------------------
# Oracle: dense integer LIF with hardware (delayed) semantics.
# ---------------------------------------------------------------------------

def run_oracle(g: SNNGraph, ext_spikes: np.ndarray,
               device: str | torch.device | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Dense reference simulation on ``device`` (``None``: the card).

    ext_spikes: ``[T, n_inputs]`` or batched ``[B, T, n_inputs]``.
    Returns (spikes ``[(B,) T, n_internal]``, v_final
    ``[(B,) n_internal]``) int32. The current is summed exactly in int64
    (a broadcast multiply and sum; CUDA has no integer GEMM) and cast
    to int32, as the reference's int64 ``s_all @ w``.
    """
    dev = resolve_device(device)
    ext = np.asarray(ext_spikes)
    squeeze = ext.ndim == 2
    if squeeze:
        ext = ext[None]
    b, t_steps, _ = ext.shape
    n_int = g.n_internal
    # dense weight matrix [n_neurons, n_internal]
    w = np.zeros((g.n_neurons, n_int), np.int64)
    w[g.pre, g.local(g.post)] = g.weight
    w = torch.from_numpy(w).to(dev)
    ext_d = torch.from_numpy(np.ascontiguousarray(ext, np.int64)).to(dev)
    v = torch.zeros((b, n_int), dtype=torch.int32, device=dev)
    s_prev = torch.zeros_like(v)
    out = torch.empty((b, t_steps, n_int), dtype=torch.int32, device=dev)
    for t in range(t_steps):
        s_all = torch.cat([ext_d[:, t], s_prev.to(torch.int64)], dim=1)
        current = (s_all[:, :, None] * w).sum(dim=1).to(torch.int32)
        v, s_prev = lif_step_int(v, current, g.lif)
        out[:, t] = s_prev
    spikes, v = out.cpu().numpy(), v.cpu().numpy()
    return (spikes[0], v[0]) if squeeze else (spikes, v)


# ---------------------------------------------------------------------------
# Functional executor of the mapped program.
# ---------------------------------------------------------------------------

class MergeAlignmentError(AssertionError):
    pass


def lif_step_int_np(v: np.ndarray, current: np.ndarray, p: LIFIntParams
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The shift-leak integer LIF step on int32 numpy arrays (the host
    simulator's Neuron Unit; :func:`repro_torch.snn.lif.lif_step_int` is
    its torch form)."""
    v_upd = v - (v >> p.leak_shift) + current
    s = v_upd >= p.v_threshold
    v_next = np.where(s, np.asarray(p.v_reset, dtype=v_upd.dtype), v_upd)
    return v_next, s.astype(np.int32)


def run_mapped(g: SNNGraph, tables: OpTables, ext_spikes: np.ndarray,
               check_alignment: bool = True,
               routing: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Execute the scheduled program. Returns (spikes, v_final, stats).

    ext_spikes: ``[T, n_inputs]``. stats carries per-timestep packet
    counts for the cycle model. ``routing`` takes the precomputed
    MC-tree bitmap (e.g. ``program.lowered.routing``); built here when
    omitted.
    """
    m, depth = tables.pre.shape
    t_steps = ext_spikes.shape[0]
    n_int = g.n_internal

    # routing bitstrings: bit[i] of neuron q == SPU i holds a synapse from q
    if routing is None:
        routing = np.zeros((g.n_neurons, m), bool)
        routing[g.pre, tables.assign] = True

    spike_mem = np.zeros((m, g.n_neurons), bool)   # per-SPU bitmap SRAM
    partial = np.zeros((m, n_int), np.int64)       # per-SPU partial currents
    v = np.zeros(n_int, np.int32)
    s_prev = np.zeros(n_int, np.int32)
    out = np.zeros((t_steps, n_int), np.int32)
    pkt_counts = np.zeros(t_steps, np.int64)

    pre_l, post_l, w_l = tables.pre, tables.post, tables.weight
    pe_l, poe_l = tables.pre_end, tables.post_end

    for t in range(t_steps):
        # ---- distribution phase: MC packets into Spike Memory ----
        fired = np.flatnonzero(np.concatenate(
            [ext_spikes[t].astype(bool), s_prev.astype(bool)]))
        pkt_counts[t] = len(fired)
        for q in fired:
            spike_mem[routing[q], q] = True

        # ---- synaptic phase: execute slots; merge in ME tree ----
        for slot in range(depth):
            valid = pre_l[:, slot] != NOP
            if not valid.any():
                continue
            spus = np.flatnonzero(valid)
            pres = pre_l[spus, slot]
            posts = post_l[spus, slot]
            act = spike_mem[spus, pres]
            loc = posts - g.n_inputs
            partial[spus, loc] += np.where(act, w_l[spus, slot], 0)
            # pre_end: clear spike bit for next timestep
            pe = pe_l[spus, slot]
            if pe.any():
                spike_mem[spus[pe], pres[pe]] = False
            # post_end: inject ME packets; bufferless merge = same slot
            poe = poe_l[spus, slot]
            if poe.any():
                inj_posts = posts[poe]
                if check_alignment and len(set(inj_posts.tolist())) != 1:
                    raise MergeAlignmentError(
                        f"t={t} slot={slot}: misaligned posts {inj_posts}")
                lq = int(inj_posts[0]) - g.n_inputs
                current = int(partial[spus[poe], lq].sum())
                partial[spus[poe], lq] = 0
                # ---- Neuron Unit: integer LIF on this neuron ----
                v_q, s_q = lif_step_int_np(
                    v[lq:lq + 1], np.array([current], np.int32), g.lif)
                v[lq] = v_q[0]
                if s_q[0]:
                    out[t, lq] = 1
        s_prev = out[t]

    return out, v, packet_stats(pkt_counts)


# ---------------------------------------------------------------------------
# Cycle-accurate timing + energy model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerModel:
    """FPGA power model with constants fitted to paper Table 2.

    P_total = static + dynamic;  dynamic = per-SPU switching cost scaled by
    datapath width, plus fabric (trees + Neuron Unit) cost.
    """
    static_w: float = 0.106                    # XC7Z020 static (Table 2)
    spu_dyn_w_per_bit: float = 0.000355        # per SPU per datapath bit
    fabric_dyn_w: float = 0.015

    def total_w(self, hw: HardwareConfig) -> float:
        bits = hw.weight_bits + hw.potential_bits
        return (self.static_w + self.fabric_dyn_w
                + hw.n_spus * bits * self.spu_dyn_w_per_bit)


@dataclasses.dataclass
class CycleReport:
    cycles_total: int
    cycles_distribution: int
    cycles_synaptic: int
    cycles_overhead: int
    latency_us: float
    power_w: float
    energy_mj: float
    energy_per_synapse_nj: float


class CycleModel:
    """Per-timestep cycle counting.

    distribution:  n_packets + 1 (end pkt) + tree_depth (MC pipeline)
    synaptic:      2 * OT_depth  (single-port Unified Memory, §4.4.3)
    drain:         tree_depth (ME adders) + 4 (NU pipeline) + 1 (end pkt)
    """
    NU_PIPELINE = 4

    def __init__(self, hw: HardwareConfig, power: PowerModel | None = None):
        self.hw = hw
        self.power = power or PowerModel()

    def timestep_cycles(self, n_packets: int, ot_depth: int,
                        n_inter_chip: int = 0) -> tuple[int, int, int]:
        d = self.hw.tree_depth
        dist = n_packets + 1 + d \
            + n_inter_chip * self.hw.inter_chip_hop_cycles
        syn = 2 * ot_depth
        drain = d + self.NU_PIPELINE + 1
        return dist, syn, drain

    def run(self, packet_counts: np.ndarray, ot_depth: int,
            n_synapses_total: int,
            inter_chip_counts: np.ndarray | None = None) -> CycleReport:
        """Aggregate one sample's per-timestep packet counts.

        ``packet_counts`` must be 1-D ``[T]``; batched ``[B, T]`` arrays
        are rejected (``Program.profile`` aggregates them per sample).
        ``inter_chip_counts`` takes the per-timestep forwarded-packet
        counts of a multi-chip mapping, each charged
        ``hw.inter_chip_hop_cycles`` distribution cycles; omitted (or all
        zero) the report is the single-chip model's.
        """
        pkts = np.asarray(packet_counts)
        if pkts.ndim != 1:
            raise ValueError(
                f"packet_counts must be 1-D [T]; got shape {pkts.shape} — "
                f"profile batched runs per sample (Program.profile "
                f"aggregates them)")
        inter = 0
        if inter_chip_counts is not None:
            ic = np.asarray(inter_chip_counts)
            if ic.shape != pkts.shape:
                raise ValueError(
                    f"inter_chip_counts shape {ic.shape} != packet_counts "
                    f"shape {pkts.shape}")
            inter = int(ic.sum()) * self.hw.inter_chip_hop_cycles
        t_steps = len(pkts)
        d = self.hw.tree_depth
        dist = int(pkts.sum()) + t_steps * (1 + d) + inter
        syn = t_steps * 2 * ot_depth
        over = t_steps * (d + self.NU_PIPELINE + 1)
        total = dist + syn + over
        lat_us = total / self.hw.clock_mhz
        p = self.power.total_w(self.hw)
        e_mj = p * lat_us * 1e-3
        eps_nj = (e_mj * 1e6 / n_synapses_total) if n_synapses_total else 0.0
        return CycleReport(total, dist, syn, over, lat_us, p, e_mj, eps_nj)
