"""The host side of ``csrc/contract_sm90.cuh``, the device design shared
by the ``fused_step`` and ``spike_accum`` kernels.

The pre (K) axis is cut into K-steps of :data:`KSTEP` neurons, the
granule of the MC-tree skip, and split over a cluster of
:func:`cluster_split` CTAs; rank ``r`` holds the K-steps
``kstep_ranges(n)[r]``. These mirror the header's functions so that the
plain-torch emulations of the kernels (``fused_step_emulated``,
``spike_accum_emulated``) replay the same decomposition.
"""
from __future__ import annotations

KSTEP = 32                 # pre neurons per K-step
MAX_CLUSTER = 8            # the portable thread-block cluster size


def cluster_split(n_ksteps: int) -> int:
    """How many CTAs of a cluster split ``n_ksteps`` K-steps."""
    return min(max(n_ksteps, 1), MAX_CLUSTER)


def kstep_ranges(n_ksteps: int) -> list[tuple[int, int]]:
    """Each rank's K-steps ``[begin, end)``, in rank order."""
    n = cluster_split(n_ksteps)
    bounds = [r * n_ksteps // n for r in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))

