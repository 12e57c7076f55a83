"""Integer range analysis over the scheduled op stream; port of
``repro/analysis/ranges.py``, numpy only.

Computes, without executing any engine, sound worst-case intervals for
every integer quantity the engine tiers manipulate:

* per-synapse weights against the signed ``weight_bits`` field
  (RANGE001);
* the folded dense weight plane ``W[q, p] = Σ weight`` that
  ``kernels/fused_step.py::pack_dense`` builds, proving its int8/int16
  choice before any densification (:func:`dense_plane_bounds`);
* the per-post synaptic accumulator and membrane potential of the
  integer LIF, proving the int32 accumulation cannot overflow, or
  naming the offending neuron and the minimal safe width (RANGE002).

The membrane bounds are a closed-form fixpoint of the reset dynamics:
the carried state never exceeds ``carried_hi = max(v_reset, 0,
v_threshold - 1)``, so the pre-threshold peak is at most
``leak(carried_hi) + pos[p]`` with ``pos[p] = Σ max(w, 0)`` over
``p``'s in-synapses; ``lo[p] = min(0, v_reset, neg[p] * 2**leak_shift)``
is an inductive lower invariant of the arithmetic-shift leak. Extremes
are finished in exact Python ints.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from repro_torch.analysis.diagnostics import (Diagnostic, Location, Severity,
                                              register_code)

if TYPE_CHECKING:
    from repro_torch.core.graph import SNNGraph
    from repro_torch.core.memory_model import HardwareConfig
    from repro_torch.core.scheduling.tables import OpTables

NOP = -1

RANGE001 = register_code(
    "RANGE001", "weight outside the signed weight_bits field")
RANGE002 = register_code(
    "RANGE002", "accumulator interval exceeds the int32 engine width")

INT32_LO, INT32_HI = -(2 ** 31), 2 ** 31 - 1


def signed_bits(lo: int, hi: int) -> int:
    """Smallest signed bit-width holding every value in [lo, hi]."""
    b = 1
    while not (-(1 << (b - 1)) <= lo and hi <= (1 << (b - 1)) - 1):
        b += 1
    return b


def min_safe_dtype(lo: int, hi: int) -> str:
    """Narrowest signed numpy dtype name holding [lo, hi] (the
    ``pack_dense`` ladder: int8 -> int16 -> int32 -> int64)."""
    b = signed_bits(int(lo), int(hi))
    for width in (8, 16, 32, 64):
        if b <= width:
            return f"int{width}"
    return f"int{b}"                     # unrepresentable in numpy; name it


def dense_plane_bounds(op_pre: np.ndarray, op_post_local: np.ndarray,
                       op_weight: np.ndarray, n_neurons: int,
                       n_internal: int) -> tuple[int, int]:
    """Exact (min, max) of the folded dense plane ``W[q, p] = Σ w``.

    Group-sums the op stream by (pre, post) without allocating the
    ``n_neurons x n_internal`` plane. Cells with no synapse hold an
    implicit 0, included whenever the plane is not fully dense.
    """
    w = np.asarray(op_weight, np.int64)
    n_cells = int(n_neurons) * int(n_internal)
    if not len(w):
        return (0, 0)
    key = (np.asarray(op_pre, np.int64) * n_internal
           + np.asarray(op_post_local, np.int64))
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sums = np.add.reduceat(w[order], starts)
    lo, hi = int(sums.min()), int(sums.max())
    if len(starts) < n_cells:            # implicit zero cells exist
        lo, hi = min(lo, 0), max(hi, 0)
    return lo, hi


def _leak_hi(v: int, shift: int) -> int:
    """``leak(v) = v - (v >> shift)`` for a non-negative carried bound."""
    return v - (v >> shift)


def check_ranges(g: "SNNGraph", hw: "HardwareConfig", tables: "OpTables"
                 ) -> tuple[list[Diagnostic], dict[str, Any]]:
    """RANGE diagnostics + the proven interval facts for (g, hw, tables).

    Folds from the TABLES (not the lowered program), so hand-edited
    artifacts are analyzed as they would execute after re-lowering.
    """
    out: list[Diagnostic] = []
    n, n_int = int(g.n_neurons), int(g.n_internal)
    valid = tables.pre != NOP
    spu_i, slot_i = np.nonzero(valid)
    pre_v = tables.pre[spu_i, slot_i].astype(np.int64)
    post_v = tables.post[spu_i, slot_i].astype(np.int64)
    w_v = tables.weight[spu_i, slot_i].astype(np.int64)
    in_range = ((pre_v >= 0) & (pre_v < n)
                & (post_v >= g.n_inputs) & (post_v < n))
    pre_v, post_v, w_v = pre_v[in_range], post_v[in_range], w_v[in_range]
    idx = np.flatnonzero(valid.ravel())[in_range]

    # -- RANGE001: every weight representable in the signed UM field --------
    ww = int(hw.weight_bits)
    w_lo, w_hi = -(1 << (ww - 1)), (1 << (ww - 1)) - 1
    bad = (w_v < w_lo) | (w_v > w_hi)
    if bad.any():
        i = int(np.argmax(bad))
        s, t = divmod(int(idx[i]), tables.pre.shape[1])
        out.append(Diagnostic(
            code=RANGE001, severity=Severity.ERROR,
            message=(f"weight {int(w_v[i])} of synapse "
                     f"({int(pre_v[i])} -> {int(post_v[i])}) outside the "
                     f"signed {ww}-bit range [{w_lo}, {w_hi}]; needs "
                     f"{signed_bits(int(w_v.min()), int(w_v.max()))} bits"),
            location=Location(spu=s, slot=t, pre=int(pre_v[i]),
                              post=int(post_v[i]), field="hw.weight_bits"),
            hint="raise HardwareConfig.weight_bits or requantize",
            count=int(bad.sum())))

    # -- per-post one-step current interval [neg, pos] ----------------------
    pos = np.zeros(n_int, np.int64)
    neg = np.zeros(n_int, np.int64)
    pl = (post_v - g.n_inputs).astype(np.int64)
    np.add.at(pos, pl, np.maximum(w_v, 0))
    np.add.at(neg, pl, np.minimum(w_v, 0))

    # -- membrane fixpoint bounds (module docstring derives both) -----------
    ls = int(g.lif.leak_shift)
    th, reset = int(g.lif.v_threshold), int(g.lif.v_reset)
    carried_hi = max(reset, 0, th - 1)
    p_hi = int(np.argmax(pos)) if n_int else 0
    p_lo = int(np.argmin(neg)) if n_int else 0
    # exact Python ints from here: the shift by leak_shift could leave
    # int64 for adversarial (leak_shift, fan-in) combinations
    v_hi = _leak_hi(carried_hi, ls) + int(pos[p_hi]) if n_int else 0
    v_lo = min(0, reset, int(neg[p_lo]) << ls) if n_int else 0
    acc_lo = min(v_lo, int(neg[p_lo]) if n_int else 0)
    acc_hi = max(v_hi, int(pos[p_hi]) if n_int else 0)
    acc_bits = signed_bits(acc_lo, acc_hi)

    if acc_lo < INT32_LO or acc_hi > INT32_HI:
        p_bad = p_hi if acc_hi > INT32_HI else p_lo
        out.append(Diagnostic(
            code=RANGE002, severity=Severity.ERROR,
            message=(f"accumulator interval [{acc_lo}, {acc_hi}] of post "
                     f"{p_bad + g.n_inputs} exceeds int32; minimal safe "
                     f"width is {acc_bits} bits ({min_safe_dtype(acc_lo, acc_hi)})"),
            location=Location(post=p_bad + g.n_inputs),
            hint="shrink weights/fan-in or widen the engine accumulator",
            count=1))

    # -- dense-plane dtype proof (the pack_dense choice) --------------------
    d_lo, d_hi = dense_plane_bounds(pre_v, pl, w_v, n, n_int)
    stats: dict[str, Any] = {
        "weight_lo": int(w_v.min()) if len(w_v) else 0,
        "weight_hi": int(w_v.max()) if len(w_v) else 0,
        "weight_bits_needed": (signed_bits(int(w_v.min()), int(w_v.max()))
                               if len(w_v) else 1),
        "dense_lo": d_lo, "dense_hi": d_hi,
        "dense_dtype": min_safe_dtype(d_lo, d_hi),
        "current_lo": int(neg[p_lo]) if n_int else 0,
        "current_hi": int(pos[p_hi]) if n_int else 0,
        "membrane_lo": v_lo, "membrane_hi": v_hi,
        "acc_lo": acc_lo, "acc_hi": acc_hi, "acc_bits": acc_bits,
        "int32_safe": INT32_LO <= acc_lo and acc_hi <= INT32_HI,
    }
    return out, stats
