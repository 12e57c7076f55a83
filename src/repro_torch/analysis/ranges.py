"""Integer range facts of the dense weight plane; port of the part of
``repro/analysis/ranges.py`` that ``kernels/fused_step.py::pack_dense``
uses: :func:`signed_bits`, :func:`min_safe_dtype` and
:func:`dense_plane_bounds`. numpy only. The checkers (RANGE001/002) wait
for the verifier slice.
"""
from __future__ import annotations

import numpy as np


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
