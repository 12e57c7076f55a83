"""The hyperedge model of the SNN fan-out and its traffic accounting;
port of the accounting half of ``repro/core/mapping/hypergraph.py``.

SupraSNN's Multi-Cast Tree delivers one spike packet to EVERY SPU that
holds a synapse of the firing neuron, so a neuron's fan-out is a
*hyperedge* (one source, many sinks) and the spike traffic of a mapping
is the number of destination SPUs each hyperedge spans (λ). This module
provides :class:`HyperView` (the CSR adjacency of the fan-out
hyperedges) and the traffic accounting behind the multi-chip cycle
model: :func:`multicast_dests`, :func:`chip_span`, :func:`mesh_hops`,
:func:`mapping_traffic`, :func:`inter_chip_packet_counts` and
:func:`inter_chip_hop_counts`. The partitioner half
(``hypergraph_partition``, ``refine_mapping``, ``balance_loads``) waits
for the partitioner (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig


# ---------------------------------------------------------------------------
# The hyperedge view.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HyperView:
    """CSR adjacency of a graph's fan-out hyperedge structure.

    ``posts`` are the graph's distinct post-neurons; post ``posts[j]``
    owns fan-in synapses ``fanin_syn[fanin_ptr[j]:fanin_ptr[j + 1]]``
    (sorted by synapse id). ``fanout_ptr``/``fanout_post`` give each
    PRE neuron's hyperedge: the posts it reaches (indexed by global
    pre id, empty rows for neurons with no fan-out).
    """
    posts: np.ndarray           # [P] distinct post ids, ascending
    fanin_ptr: np.ndarray       # [P+1] CSR offsets into fanin_syn
    fanin_syn: np.ndarray       # [E] synapse ids grouped by post
    fanout_ptr: np.ndarray      # [n_neurons+1] CSR offsets per pre
    fanout_post: np.ndarray     # [E] post ids grouped by pre

    @property
    def n_posts(self) -> int:
        return int(len(self.posts))

    def fanin(self, j: int) -> np.ndarray:
        """Synapse ids of post ``posts[j]``."""
        return self.fanin_syn[self.fanin_ptr[j]:self.fanin_ptr[j + 1]]


def hyper_view(g: SNNGraph) -> HyperView:
    """Build the CSR hyperedge view (two argsorts, no Python loops)."""
    e = g.n_synapses
    order = np.argsort(g.post.astype(np.int64) * e + np.arange(e))
    posts = np.unique(g.post).astype(np.int64)
    fanin_ptr = np.searchsorted(g.post[order], np.r_[posts, g.n_neurons])
    fanin_ptr = np.r_[fanin_ptr[:-1], e].astype(np.int64)
    by_pre = np.argsort(g.pre.astype(np.int64) * np.int64(g.n_neurons)
                        + g.post)
    fanout_ptr = np.searchsorted(
        g.pre[by_pre], np.arange(g.n_neurons + 1)).astype(np.int64)
    return HyperView(posts, fanin_ptr, order.astype(np.int64),
                     fanout_ptr, g.post[by_pre].astype(np.int64))


# ---------------------------------------------------------------------------
# Traffic accounting (the hyperedge connectivity metric + chips).
# ---------------------------------------------------------------------------

def multicast_dests(g: SNNGraph, assign: np.ndarray, n_spus: int
                    ) -> np.ndarray:
    """[n_neurons] destination-SPU count of each neuron's hyperedge.

    Entry q is the number of SPUs holding at least one synapse with
    pre q — the MC-tree deliveries one spike of q costs (λ of the
    hyperedge). Zero for neurons without fan-out.
    """
    pairs = np.unique(g.pre.astype(np.int64) * n_spus
                      + assign.astype(np.int64))
    return np.bincount(pairs // n_spus, minlength=g.n_neurons)


def chip_span(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig
              ) -> np.ndarray:
    """[n_neurons] distinct chips each neuron's fan-out spans."""
    chips = hw.chip_of(assign.astype(np.int64))
    pairs = np.unique(g.pre.astype(np.int64) * hw.n_chips + chips)
    return np.bincount(pairs // hw.n_chips, minlength=g.n_neurons)


def mesh_hops(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig
              ) -> np.ndarray:
    """[n_neurons] 2D-mesh hop cost of each neuron's multicast.

    With the chips on an XY-routed ``mesh_x × mesh_y`` grid
    (DESIGN.md §12), a multicast to destination chip set D costs at
    least the half-perimeter of D's bounding box — the hop count of a
    dimension-ordered distribution tree, and the standard wirelength
    proxy the placer/refiner optimize. Zero for neurons whose fan-out
    stays on one chip; on a ``mesh_y == 1`` chain of two chips this is
    exactly the §11 ``span - 1`` forward count.
    """
    mx, my = hw.mesh_dims
    chips = hw.chip_of(assign.astype(np.int64))
    pairs = np.unique(g.pre.astype(np.int64) * hw.n_chips + chips)
    p, c = pairs // hw.n_chips, pairs % hw.n_chips
    cx, cy = c % mx, c // mx
    n = g.n_neurons
    minx = np.full(n, mx, np.int64)
    maxx = np.full(n, -1, np.int64)
    miny = np.full(n, my, np.int64)
    maxy = np.full(n, -1, np.int64)
    np.minimum.at(minx, p, cx)
    np.maximum.at(maxx, p, cx)
    np.minimum.at(miny, p, cy)
    np.maximum.at(maxy, p, cy)
    return np.where(maxx >= 0, (maxx - minx) + (maxy - miny), 0)


def mapping_traffic(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig
                    ) -> dict:
    """Static spike-traffic metrics of a mapping (per source spike).

    ``dests_total`` is the summed hyperedge connectivity λ (fabric
    deliveries if every source fired once); ``inter_chip_total`` the
    summed (chips spanned - 1) forwards; ``mesh_hops_total`` the summed
    2D-mesh bounding-box hops (== ``inter_chip_total`` on a two-chip
    chain). ``dests_total`` is invariant under the chip grouping and
    the chip terms are 0 at ``n_chips=1`` — the conservation the
    multi-chip model must keep.
    """
    dests = multicast_dests(g, assign, hw.n_spus)
    span = chip_span(g, assign, hw)
    sources = dests > 0
    return {
        "dests_total": int(dests.sum()),
        "dests_mean": float(dests[sources].mean()) if sources.any() else 0.0,
        "inter_chip_total": int(np.maximum(span - 1, 0).sum()),
        "mesh_hops_total": int(mesh_hops(g, assign, hw).sum()),
        "n_sources": int(sources.sum()),
    }


def _weighted_spike_counts(ext_spikes: np.ndarray, spikes: np.ndarray,
                           weights: np.ndarray) -> np.ndarray:
    """Per-timestep Σ weights[q] over the firing neurons of each step.

    Mirrors :func:`repro_torch.core.engine.oracle_packet_counts`: the
    distribution phase of timestep t carries the external inputs of t
    plus the internal spikes of t-1. ``weights`` is indexed by global
    neuron id (length ``n_neurons``; the internal block is its tail).
    Accepts ``[T, n]`` or batched ``[B, T, n]`` spike arrays, returning
    ``[T]`` / ``[B, T]`` counts.
    """
    ext = np.asarray(ext_spikes)
    s = np.asarray(spikes)
    if ext.ndim not in (2, 3) or s.ndim != ext.ndim:
        raise ValueError(f"expected matching [T, n] or [B, T, n] arrays; "
                         f"got {ext.shape} and {s.shape}")
    w = np.asarray(weights, np.int64)
    n_in = ext.shape[-1]
    ext_w = w[:n_in]
    int_w = w[len(w) - s.shape[-1]:]
    counts = (ext != 0).astype(np.int64) @ ext_w
    counts[..., 1:] += (s[..., :-1, :] != 0).astype(np.int64) @ int_w
    return counts


def inter_chip_packet_counts(ext_spikes: np.ndarray, spikes: np.ndarray,
                             span: np.ndarray) -> np.ndarray:
    """Per-timestep inter-chip forwarded packets of a run: each firing
    neuron q adds ``max(span[q] - 1, 0)`` forwards (``span`` is the
    :func:`chip_span` vector) — the §11 topology-blind forward count."""
    hops = np.maximum(np.asarray(span, np.int64) - 1, 0)
    return _weighted_spike_counts(ext_spikes, spikes, hops)


def inter_chip_hop_counts(ext_spikes: np.ndarray, spikes: np.ndarray,
                          hops: np.ndarray) -> np.ndarray:
    """Per-timestep inter-chip MESH HOPS of a run: each firing neuron q
    adds ``hops[q]`` (the :func:`mesh_hops` vector), so the cycle
    model's ``inter_chip_hop_cycles`` charge scales with the actual
    XY-mesh distance the multicast travels (DESIGN.md §12)."""
    return _weighted_spike_counts(ext_spikes, spikes,
                                  np.asarray(hops, np.int64))
