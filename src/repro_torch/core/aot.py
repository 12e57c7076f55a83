"""Serving shapes, the kernels' build directory and the artifact's
identity; port of ``repro/core/aot.py``.

The reference's persistent XLA cache keeps compiled code between
processes. The port's compiled code is the kernels' library, built by
``nvcc`` on first use and kept on disk, keyed by a hash of its sources
(:mod:`repro_torch.kernels._build`): :func:`enable_persistent_cache`
names the directory it is built into and loaded from, so a restarted
process loads it there without building. The per-shape CUDA graphs of
``precompile`` live with the engine.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

ENV_CACHE_DIR = "SUPRASNN_TORCH_CACHE_DIR"
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[1] / "kernels"
                        / "_build")

_cache_dir: str | None = None


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """The directory the CUDA kernels' library is built into and loaded
    from; returns it.

    Resolution order: explicit argument > ``SUPRASNN_TORCH_CACHE_DIR`` >
    ``kernels/_build`` beside the package (listed in ``.gitignore``).
    Idempotent — later calls with no argument keep the first directory.
    Nothing is built or created here; a library the process has already
    loaded stays loaded.
    """
    global _cache_dir
    if cache_dir is None:
        if _cache_dir is not None:
            return _cache_dir
        cache_dir = os.environ.get(ENV_CACHE_DIR) or DEFAULT_CACHE_DIR
    _cache_dir = str(Path(cache_dir).expanduser())
    return _cache_dir


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
