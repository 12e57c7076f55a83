"""Serving shapes and the artifact's identity; port of
``normalize_buckets`` and ``content_hash`` from ``repro/core/aot.py``.

The reference's persistent XLA cache (``enable_persistent_cache``) has
no counterpart here: the port's compiled code is the kernels' library,
kept between processes in ``kernels/_build/`` and keyed by a hash of
its sources; the per-shape CUDA graphs of ``precompile`` live with the
engine.
"""
from __future__ import annotations

import hashlib

import numpy as np


def normalize_buckets(buckets) -> tuple[int, ...]:
    """Coerce a ``BatchPolicy`` or iterable of batch sizes to sorted
    unique positive ints — the shapes precompile walks."""
    buckets = getattr(buckets, "buckets", buckets)
    if isinstance(buckets, (int, np.integer)):
        buckets = (buckets,)
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"precompile buckets must be positive batch "
                         f"sizes, got {buckets}")
    return out


def content_hash(program) -> str:
    """SHA-256 of everything that determines the compiled computation.

    Covers the lowered op stream, the routing matrix, the LIF
    parameters and the problem dims — NOT the search/report metadata,
    so re-compiling the same mapping hashes identically. The same
    string as the reference's for the same artifact.
    """
    lw = program.lowered
    h = hashlib.sha256()
    for name in ("op_spu", "op_slot", "op_pre", "op_post_local",
                 "op_weight", "op_pre_end", "op_post_end", "routing"):
        a = np.ascontiguousarray(getattr(lw, name))
        h.update(f"{name}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    lif = program.graph.lif
    h.update(f"lif:{lif.leak_shift}:{lif.v_threshold}:{lif.v_reset}"
             f":dims:{lw.n_inputs}:{lw.n_neurons}:{lw.n_internal}"
             f":{lw.n_spus}:{lw.depth}".encode())
    return h.hexdigest()
