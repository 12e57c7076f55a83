"""Hyperedge model of the SNN fan-out + overlap-driven mapping (§11/§12);
port of ``repro/core/mapping/hypergraph.py``.

SupraSNN's Multi-Cast Tree delivers one spike packet to EVERY SPU that
holds a synapse of the firing neuron — a neuron's fan-out is therefore
a *hyperedge* (one source, many sinks), and the spike traffic of a
mapping is the classic hypergraph connectivity metric: the number of
destination SPUs each hyperedge spans (λ). Standard graph partitioning
cannot see this multicast reuse; hyperedge-overlap partitioning
(Ronzani & Silvano 2026) reports 20–30% less inter-core traffic by
maximizing co-destination overlap. This module provides:

* :class:`HyperView` — CSR adjacency of the fan-out hyperedges over an
  :class:`~repro_torch.core.graph.SNNGraph` (post -> fan-in synapses,
  pre -> fan-out posts);
* :func:`hypergraph_partition` — a deterministic greedy partitioner
  that places whole fan-in groups by descending size, choosing the SPU
  maximizing the second-order affinity term (shared fan-in pres ->
  reused multicast deliveries, then shared weight values -> reused UM
  lines) among the Eq. (9)-feasible SPUs;
* :func:`refine_mapping` — FM-style boundary refinement moving whole
  (SPU, post) fan-in groups under the extended objective
  ``J = (overflow, traffic)``: Eq. (10) overflow lines first, then
  multicast deliveries + mesh-hop-weighted inter-chip forwards
  (DESIGN.md §12). Each pass evaluates EVERY group's move deltas in
  one vectorized sweep off the occupancy :class:`Books` (no per-group
  Python recomputation), then applies the winners with a cheap scalar
  recheck against live state — so acceptance stays strictly
  monotone and the refined mapping NEVER scores worse than its input
  (the multilevel mapper's uncoarsening contract);
* :func:`balance_loads` — within-chip OT load balancing: the
  traffic-first refinement concentrates fan-in groups, which blows up
  the OT depth (the busiest SPU's operation count); this pass spreads
  whole groups from each chip's most- to least-loaded SPUs under
  Eq. (9), leaving chip-level (mesh) traffic invariant;
* traffic accounting — :func:`multicast_dests`, :func:`chip_span`,
  :func:`mesh_hops`, :func:`mapping_traffic`,
  :func:`inter_chip_packet_counts`, :func:`inter_chip_hop_counts` —
  the static mapping metrics behind the ``mapping.*`` benchmark rows
  and the multi-chip cycle-model term.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import Books, PartitionResult
from repro_torch.core.memory_model import HardwareConfig, scores_from_assignment


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


# ---------------------------------------------------------------------------
# Greedy hyperedge-overlap partitioning.
# ---------------------------------------------------------------------------

def hypergraph_partition(g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                         refine: bool = True, refine_passes: int = 2,
                         balance: bool = True) -> PartitionResult:
    """Deterministic greedy overlap partitioner (Ronzani & Silvano style).

    Whole fan-in groups are placed in descending size order (heaviest
    posts first — they fix the layout the small ones then overlap
    onto). For each post the destination is chosen among the SPUs that
    stay Eq. (9)-feasible by the lexicographic affinity key

        (max shared fan-in pres, min new UM weight lines,
         max remaining Eq. (10) score, min SPU id)

    — multicast reuse first (every shared pre is one MC delivery the
    SPU already receives), weight reuse second, load balance third.
    If no SPU stays feasible the least-overflowing one is taken and
    the result may be infeasible (exactly like the baselines). A
    final :func:`refine_mapping` pass (on by default) cleans up the
    greedy tail, and :func:`balance_loads` (``balance=True``) spreads
    the op load within each chip so the OT depth tracks the mean SPU
    load, not the overlap-greedy maximum. ``seed`` is accepted for the
    :class:`~repro_torch.core.mapping.strategies.MappingStrategy` protocol;
    the algorithm is deterministic and ignores it.
    """
    hv = hyper_view(g)
    m, k, cap = hw.n_spus, hw.concentration, hw.unified_mem_depth
    w_vals, w_id = np.unique(g.weight, return_inverse=True)
    nw = len(w_vals)

    pre_present = np.zeros((m, g.n_neurons), bool)
    w_present = np.zeros((m, nw), bool)
    n_posts = np.zeros(m, np.int64)
    n_weights = np.zeros(m, np.int64)
    assign = np.zeros(g.n_synapses, np.int32)

    sizes = np.diff(hv.fanin_ptr)
    order = np.lexsort((hv.posts, -sizes))      # big fan-ins first
    spu_idx = np.arange(m)
    for j in order:
        syns = hv.fanin(j)
        pres = g.pre[syns].astype(np.int64)     # unique: one syn per (pre, q)
        uw = np.unique(w_id[syns])
        overlap = pre_present[:, pres].sum(1)                    # [M]
        new_w = (~w_present[:, uw]).sum(1)                       # [M]
        lines_now = -(-(n_weights + 1) // k) + n_posts
        lines_after = -(-(n_weights + new_w + 1) // k) + n_posts + 1
        feasible = lines_after <= cap
        if feasible.any():
            # lexicographic affinity key over the feasible SPUs
            f = spu_idx[feasible]
            pick = f[np.lexsort((f, lines_after[f],
                                 lines_after[f] - lines_now[f],
                                 -overlap[f]))[0]]
        else:
            pick = int(np.lexsort((spu_idx, lines_after))[0])
        assign[syns] = pick
        pre_present[pick, pres] = True
        w_present[pick, uw] = True
        n_posts[pick] += 1
        n_weights[pick] = w_present[pick].sum()

    iterations = hv.n_posts
    if refine:
        assign, stats = refine_mapping(g, hw, assign, passes=refine_passes)
        iterations += stats.moves
    if balance:
        assign, bstats = balance_loads(g, hw, assign)
        iterations += bstats["moves"]
    scores = scores_from_assignment(g.weight, g.post, assign, hw)
    return PartitionResult(assign.astype(np.int32), scores,
                           bool(scores.min() >= 0), iterations, 0, [])


# ---------------------------------------------------------------------------
# FM-style boundary refinement under the extended objective.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefineStats:
    """What one :func:`refine_mapping` call did (and proves)."""
    passes: int
    moves: int
    overflow_before: int
    overflow_after: int
    traffic_before: int
    traffic_after: int


def _overflow(scores: np.ndarray) -> int:
    """Total Eq. (10) violation lines (0 iff the mapping is feasible)."""
    return int(np.maximum(-scores, 0).sum())


def _extent_lut(bits: int) -> np.ndarray:
    """LUT over occupancy bitmasks of one mesh axis: mask -> extent
    (msb - lsb), the axis' contribution to the bounding-box hops."""
    if bits > 16:
        raise ValueError(f"mesh axis of {bits} chips is beyond the LUT "
                         f"model (max 16 per axis)")
    masks = np.arange(1, 1 << bits, dtype=np.int64)
    msb = np.floor(np.log2(masks)).astype(np.int64)
    lsb = np.floor(np.log2(masks & -masks)).astype(np.int64)
    return np.r_[0, msb - lsb]


class _MeshState:
    """Incremental per-axis chip-occupancy state of a mapping.

    For each pre neuron, ``colmask``/``rowmask`` hold the bitmask of
    occupied mesh columns/rows and ``cnt_col``/``cnt_row`` the synapse
    counts behind each bit, so a group move updates masks in O(group)
    and the bounding-box hop total stays exact (== Σ
    :func:`mesh_hops`). Only built when ``n_chips > 1``.
    """

    def __init__(self, hw: HardwareConfig, cnt_pre: np.ndarray):
        self.mx, self.my = hw.mesh_dims
        self.spc = hw.spus_per_chip
        n = cnt_pre.shape[1]
        cnt_chip = cnt_pre.reshape(hw.n_chips, self.spc, n).sum(1)
        self.cnt_col = np.ascontiguousarray(
            cnt_chip.reshape(self.my, self.mx, n).sum(0))        # [mx, n]
        self.cnt_row = np.ascontiguousarray(
            cnt_chip.reshape(self.my, self.mx, n).sum(1))        # [my, n]
        self.colmask = ((self.cnt_col > 0).astype(np.int64)
                        * (np.int64(1) << np.arange(self.mx))[:, None]
                        ).sum(0)                                 # [n]
        self.rowmask = ((self.cnt_row > 0).astype(np.int64)
                        * (np.int64(1) << np.arange(self.my))[:, None]
                        ).sum(0)
        self.ext_x = _extent_lut(self.mx)
        self.ext_y = _extent_lut(self.my)
        self.total = int((self.ext_x[self.colmask]
                          + self.ext_y[self.rowmask]).sum())

    def chip_xy(self, spu):
        c = spu // self.spc
        return c % self.mx, c // self.mx

    def move_masks(self, pres, sx, sy, dx, dy):
        """New (colmask, rowmask) per pre if one synapse of each pre in
        ``pres`` moves from mesh cell (sx, sy) to (dx, dy). ``sx``/``sy``
        are per-pre arrays or scalars; ``dx``/``dy`` scalars."""
        cm, rm = self.colmask[pres], self.rowmask[pres]
        gone_c = self.cnt_col[sx, pres] == 1
        gone_r = self.cnt_row[sy, pres] == 1
        new_cm = np.where(gone_c, cm & ~(np.int64(1) << sx), cm) \
            | (np.int64(1) << dx)
        new_rm = np.where(gone_r, rm & ~(np.int64(1) << sy), rm) \
            | (np.int64(1) << dy)
        return cm, rm, new_cm, new_rm

    def hops_delta(self, pres, src_spu, dst_spu) -> int:
        """Exact Σ bounding-box hop delta of moving one synapse of each
        pre in ``pres`` (unique) from ``src_spu`` to ``dst_spu``."""
        sx, sy = self.chip_xy(src_spu)
        dx, dy = self.chip_xy(dst_spu)
        if sx == dx and sy == dy:
            return 0
        cm, rm, new_cm, new_rm = self.move_masks(pres, sx, sy, dx, dy)
        return int((self.ext_x[new_cm] - self.ext_x[cm]
                    + self.ext_y[new_rm] - self.ext_y[rm]).sum())

    def apply(self, pres, src_spu, dst_spu, delta: int) -> None:
        """Commit a group move (``pres`` unique within the group)."""
        sx, sy = self.chip_xy(src_spu)
        dx, dy = self.chip_xy(dst_spu)
        if sx == dx and sy == dy:
            return
        self.cnt_col[sx, pres] -= 1
        vac = self.cnt_col[sx, pres] == 0
        self.colmask[pres[vac]] &= ~(np.int64(1) << sx)
        self.cnt_col[dx, pres] += 1
        new = self.cnt_col[dx, pres] == 1
        self.colmask[pres[new]] |= np.int64(1) << dx
        self.cnt_row[sy, pres] -= 1
        vac = self.cnt_row[sy, pres] == 0
        self.rowmask[pres[vac]] &= ~(np.int64(1) << sy)
        self.cnt_row[dy, pres] += 1
        new = self.cnt_row[dy, pres] == 1
        self.rowmask[pres[new]] |= np.int64(1) << dy
        self.total += delta


def refine_mapping(g: SNNGraph, hw: HardwareConfig, assign: np.ndarray, *,
                   passes: int = 3, repair_rounds: int = 32
                   ) -> tuple[np.ndarray, RefineStats]:
    """FM-style whole-group boundary refinement of a mapping.

    Moves (SPU, post) fan-in groups between SPUs, accepting a move only
    on STRICT lexicographic improvement of

        J = (overflow, traffic)
        overflow = Σ_i max(0, -score_i)            -- Eq. (10) repair
        traffic  = Σ_q λ(q) + hop · Σ_q mesh(q)    -- multicast reuse

    where λ(q) is the destination-SPU count of neuron q's hyperedge,
    ``mesh(q)`` its 2D-mesh bounding-box hops (:func:`mesh_hops`), and
    ``hop = hw.inter_chip_hop_cycles`` prices each mesh hop
    (DESIGN.md §12; on a two-chip chain the mesh term IS the §11
    ``span - 1`` forward count, bit-identically).

    Each pass (1) snapshots the (SPU, post) grouping, (2) evaluates the
    move deltas of EVERY group to EVERY SPU in one chunked vectorized
    sweep off the occupancy :class:`Books` planes, and (3) applies the
    per-group best strictly-improving candidates in worst-SPU-first
    order, rechecking each against the LIVE books with an O(group)
    scalar pass before committing — stale snapshots (the group moved or
    another merged into it) are skipped, exactly like the former
    per-group scan, so acceptance stays strict and the returned mapping
    NEVER scores worse than the input on (overflow, traffic). The pass loop stops early
    when a full sweep accepts nothing.

    Snapshot deltas go stale as moves land within a pass, so the batch
    sweeps can stall short of feasibility; up to ``repair_rounds``
    LIVE sweeps over the groups still sitting on overflowing SPUs run
    afterwards (each move strictly reduces total overflow, so the
    lexicographic guarantee holds). Few groups remain by then, which
    keeps the live scan cheap — it is the targeted remainder of the
    former always-live pass.
    """
    m, k, cap = hw.n_spus, hw.concentration, hw.unified_mem_depth
    hop = hw.inter_chip_hop_cycles if hw.n_chips > 1 else 0
    assign = assign.astype(np.int32).copy()
    books = Books(g, hw, assign[None])
    w_id = books.w_id
    nw = books.n_wvals
    pre = g.pre.astype(np.int64)
    post = g.post.astype(np.int64)
    n = g.n_neurons

    cnt_pre = np.zeros((m, n), np.int32)
    np.add.at(cnt_pre, (assign, pre), 1)
    dests = int((cnt_pre > 0).sum())
    mesh = _MeshState(hw, cnt_pre) if hop else None

    scores = books.scores_r(0)
    overflow = _overflow(scores)
    traffic = dests + hop * (mesh.total if mesh else 0)
    stats = RefineStats(0, 0, overflow, overflow, traffic, traffic)

    def lines_of(nw_, np_):
        return -(-(nw_ + 1) // k) + np_

    # chunk caps: bound the [nc, M] / [nc, nw] delta planes and the
    # [M, chunk_synapses] boundary plane to a few tens of MB each
    chunk_syns = max(4096, (1 << 25) // m)
    nc_cap = max(256, (1 << 21) // max(nw, m))

    for _ in range(passes):
        stats.passes += 1
        accepted = False
        # ---- snapshot grouping --------------------------------------------
        key = assign.astype(np.int64) * n + post
        uniq, inv = np.unique(key, return_inverse=True)
        n_groups = len(uniq)
        if not n_groups:
            break
        g_spu = (uniq // n).astype(np.int64)
        g_post = (uniq % n).astype(np.int64)
        syn_order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=n_groups)
        starts = np.r_[0, np.cumsum(counts)]

        # ---- batched delta evaluation vs the pass-start snapshot ----------
        best_d = np.zeros(n_groups, np.int64)
        has_cand = np.zeros(n_groups, bool)
        nw0, np0 = books.n_weights[0], books.n_posts[0]
        pen0 = np.maximum(-scores, 0)                            # [M]
        new_w_dest = (books.cnt_w[0] == 0).astype(np.int32)      # [M, nw]
        c0 = 0
        while c0 < n_groups:
            c1 = int(np.searchsorted(starts, starts[c0] + chunk_syns,
                                     side="right")) - 1
            c1 = min(max(c1, c0 + 1), c0 + nc_cap, n_groups)
            nc = c1 - c0
            sz = counts[c0:c1]
            syns_ch = syn_order[starts[c0]:starts[c1]]
            loc = (starts[c0:c1] - starts[c0]).astype(np.intp)
            pres = pre[syns_ch]
            i_ch = g_spu[c0:c1]
            q_ch = g_post[c0:c1]
            rep = np.repeat(np.arange(nc, dtype=np.intp), sz)

            # Δoverflow [nc, M]
            cw_g = np.zeros((nc, nw), np.int32)
            np.add.at(cw_g, (rep, w_id[syns_ch]), 1)
            present = cw_g > 0
            gone_w = ((books.cnt_w[0, i_ch] == cw_g) & present).sum(1)
            new_w = present.astype(np.int32) @ new_w_dest.T      # [nc, M]
            no_q = (books.cnt_post[0][:, q_ch] == 0).T           # [nc, M]
            sc_i_new = cap - lines_of(nw0[i_ch] - gone_w, np0[i_ch] - 1)
            sc_d_new = cap - lines_of(nw0[None, :] + new_w,
                                      np0[None, :] + no_q)
            d_over = (np.maximum(-sc_i_new, 0)[:, None] - pen0[i_ch][:, None]
                      + np.maximum(-sc_d_new, 0) - pen0[None, :])

            # Δdests [nc, M]
            leave = np.add.reduceat(
                (cnt_pre[np.repeat(i_ch, sz), pres] == 1).astype(np.int64),
                loc)
            add_d = np.add.reduceat((cnt_pre[:, pres] == 0).astype(np.int64),
                                    loc, axis=1)                 # [M, nc]
            d_traf = add_d.T - leave[:, None]

            # Δmesh hops [nc, M] (chip-resolution, expanded over SPUs)
            if mesh is not None:
                sx, sy = mesh.chip_xy(i_ch)
                sx_s, sy_s = sx[rep], sy[rep]
                base = (mesh.ext_x[mesh.colmask[pres]]
                        + mesh.ext_y[mesh.rowmask[pres]])
                d_chip = np.zeros((nc, hw.n_chips), np.int64)
                for cd in range(hw.n_chips):
                    dx, dy = cd % mesh.mx, cd // mesh.mx
                    _, _, new_cm, new_rm = mesh.move_masks(
                        pres, sx_s, sy_s, dx, dy)
                    dh = mesh.ext_x[new_cm] + mesh.ext_y[new_rm] - base
                    d_chip[:, cd] = np.add.reduceat(dh, loc)
                d_traf = d_traf + hop * d_chip[
                    :, np.arange(m) // hw.spus_per_chip]

            # per-group best strictly-improving (d_over, d_traf, spu)
            rows = np.arange(nc)
            d_over[rows, i_ch] = 0
            d_traf[rows, i_ch] = 0
            better = (d_over < 0) | ((d_over == 0) & (d_traf < 0))
            better[rows, i_ch] = False
            k1 = 2 * int(np.abs(d_traf).max(initial=0)) + 1
            lex = (d_over * k1 + d_traf) * m + np.arange(m)[None, :]
            lex = np.where(better, lex, np.iinfo(np.int64).max)
            best_d[c0:c1] = np.argmin(lex, axis=1)
            has_cand[c0:c1] = better.any(1)
            c0 = c1

        # ---- apply, worst-SPU-first, with a live-state recheck ------------
        visit = np.lexsort((g_post, scores[g_spu]))
        for gi in visit[has_cand[visit]]:
            i, q, d = int(g_spu[gi]), int(g_post[gi]), int(best_d[gi])
            syns = syn_order[starts[gi]:starts[gi + 1]]
            # groups move whole, so a changed first-synapse owner means
            # the group left i; a changed count means another (i', q)
            # group merged INTO i — either way this snapshot is stale and
            # its deltas would be wrong, so revisit next pass instead
            if int(assign[syns[0]]) != i \
                    or int(books.cnt_post[0, i, q]) != len(syns):
                continue
            pres_g = pre[syns]
            wc = np.bincount(w_id[syns], minlength=nw)
            moved_w = wc > 0
            gone = int(((books.cnt_w[0, i] == wc) & moved_w).sum())
            new = int(((books.cnt_w[0, d] == 0) & moved_w).sum())
            sc_i = cap - lines_of(int(books.n_weights[0, i]) - gone,
                                  int(books.n_posts[0, i]) - 1)
            sc_d = cap - lines_of(
                int(books.n_weights[0, d]) + new,
                int(books.n_posts[0, d])
                + (1 if books.cnt_post[0, d, q] == 0 else 0))
            d_over = (max(-sc_i, 0) - max(-int(scores[i]), 0)
                      + max(-sc_d, 0) - max(-int(scores[d]), 0))
            d_dests = (int((cnt_pre[d, pres_g] == 0).sum())
                       - int((cnt_pre[i, pres_g] == 1).sum()))
            d_mesh = mesh.hops_delta(pres_g, i, d) if mesh else 0
            d_traf = d_dests + hop * d_mesh
            if not (d_over < 0 or (d_over == 0 and d_traf < 0)):
                continue

            books.move_group(0, syns, i, d)
            assign[syns] = d
            cnt_pre[i, pres_g] -= 1
            cnt_pre[d, pres_g] += 1
            if mesh is not None:
                mesh.apply(pres_g, i, d, d_mesh)
            dests += d_dests
            overflow += d_over
            scores[i], scores[d] = sc_i, sc_d
            stats.moves += 1
            accepted = True
        if not accepted:
            break

    # ---- live repair of the residual overflow -----------------------------
    # every accept strictly reduces total overflow (traffic only breaks
    # candidate ties), so this is still a lexicographic improvement
    spus = np.arange(m)
    for _ in range(repair_rounds):
        if overflow <= 0:
            break
        key = assign.astype(np.int64) * n + post
        uniq, inv = np.unique(key, return_inverse=True)
        g_spu = (uniq // n).astype(np.int64)
        g_post = (uniq % n).astype(np.int64)
        syn_order = np.argsort(inv, kind="stable")
        starts = np.r_[0, np.cumsum(np.bincount(inv, minlength=len(uniq)))]
        order = np.lexsort((g_post, scores[g_spu]))
        order = order[scores[g_spu[order]] < 0]
        accepted = False
        nw0, np0 = books.n_weights[0], books.n_posts[0]      # live views
        for gi in order:
            i, q = int(g_spu[gi]), int(g_post[gi])
            if scores[i] >= 0:
                continue
            syns = syn_order[starts[gi]:starts[gi + 1]]
            if int(assign[syns[0]]) != i \
                    or int(books.cnt_post[0, i, q]) != len(syns):
                continue
            pres_g = pre[syns]
            wc = np.bincount(w_id[syns], minlength=nw)
            moved_w = wc > 0
            gone_w = int(((books.cnt_w[0, i] == wc) & moved_w).sum())
            new_w = (books.cnt_w[0][:, moved_w] == 0).sum(1)     # [M]
            no_q = books.cnt_post[0, :, q] == 0
            sc_i_new = cap - lines_of(int(nw0[i]) - gone_w, int(np0[i]) - 1)
            sc_d_new = cap - lines_of(nw0 + new_w, np0 + no_q)
            pen = np.maximum(-scores, 0)
            d_over = (max(-sc_i_new, 0) - pen[i]
                      + np.maximum(-sc_d_new, 0) - pen)
            d_dests = ((cnt_pre[:, pres_g] == 0).sum(1)
                       - int((cnt_pre[i, pres_g] == 1).sum()))
            d_over[i] = 0
            better = d_over < 0
            better[i] = False
            if not better.any():
                continue
            cand = spus[better]
            d = int(cand[np.lexsort((cand, d_dests[cand],
                                     d_over[cand]))[0]])
            d_mesh = mesh.hops_delta(pres_g, i, d) if mesh else 0
            books.move_group(0, syns, i, d)
            assign[syns] = d
            cnt_pre[i, pres_g] -= 1
            cnt_pre[d, pres_g] += 1
            if mesh is not None:
                mesh.apply(pres_g, i, d, d_mesh)
            dests += int(d_dests[d])
            overflow += int(d_over[d])
            scores[i], scores[d] = sc_i_new, int(sc_d_new[d])
            stats.moves += 1
            accepted = True
        if not accepted:
            break

    stats.overflow_after = _overflow(books.scores_r(0))
    stats.traffic_after = dests + hop * (mesh.total if mesh else 0)
    return assign, stats


# ---------------------------------------------------------------------------
# Within-chip OT load balancing (DESIGN.md §12 satellite).
# ---------------------------------------------------------------------------

def balance_loads(g: SNNGraph, hw: HardwareConfig, assign: np.ndarray, *,
                  max_moves: int | None = None
                  ) -> tuple[np.ndarray, dict]:
    """Spread per-SPU op load within each chip under Eq. (9).

    The OT depth tracks the busiest SPU's operation count (≈ its
    synapse count plus stored posts), and the traffic-first greedy/
    refinement concentrate fan-in groups — great for multicast reuse,
    terrible for the schedule. This pass repeatedly moves the
    best-fitting whole (SPU, post) fan-in group from each chip's most-
    loaded SPU to its least-loaded one, accepting a move only when the
    total Eq. (9) violation does not increase (on feasible instances
    the receiving SPU stays feasible; on infeasible ones draining the
    overfull SPU may even repair lines) and the load gap strictly
    shrinks. Moves never cross chips, so the
    chip-level traffic (:func:`mesh_hops`, :func:`chip_span`) is
    INVARIANT — only λ within the chip may grow, which is the recorded
    depth-vs-packets tradeoff (`mapping.hypergraph.balanced_*` rows).

    Returns ``(assign, stats)`` with ``stats`` holding move count and
    the max per-SPU load before/after.
    """
    m, k, cap = hw.n_spus, hw.concentration, hw.unified_mem_depth
    spc = hw.spus_per_chip
    assign = assign.astype(np.int32).copy()
    books = Books(g, hw, assign[None])
    w_id, nw = books.w_id, books.n_wvals
    post = g.post.astype(np.int64)
    if max_moves is None:
        max_moves = 8 * m

    load = (np.bincount(assign, minlength=m).astype(np.int64)
            + books.n_posts[0])
    scores = books.scores_r(0)
    stats = {"moves": 0, "max_load_before": int(load.max(initial=0)),
             "max_load_after": 0}

    # one snapshot grouping; moved groups keep their (new) owner for the
    # rest of the call, so membership never goes stale
    key = assign.astype(np.int64) * g.n_neurons + post
    uniq, inv = np.unique(key, return_inverse=True)
    syn_order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.cumsum(np.bincount(inv))]
    g_spu = (uniq // g.n_neurons).astype(np.int64)
    g_size = np.diff(starts)

    def lines_of(nw_, np_):
        return -(-(nw_ + 1) // k) + np_

    # per SPU: its group indices, largest first (deterministic)
    by_spu = [[] for _ in range(m)]
    for gi in np.lexsort((np.arange(len(uniq)), -g_size)):
        by_spu[g_spu[gi]].append(int(gi))

    for chip in range(hw.n_chips):
        spus = np.arange(chip * spc, (chip + 1) * spc)
        for _ in range(max_moves // max(hw.n_chips, 1) + 1):
            order = np.argsort(load[spus], kind="stable")
            moved = False
            for i in map(int, spus[order[::-1]]):      # most loaded first
                gis = np.array(by_spu[i], dtype=np.int64)
                if not len(gis):
                    continue
                # evaluate EVERY (group of i -> SPU of chip) move at once:
                # the binding constraint is usually weight lines, so the
                # good receiver is the one already holding the group's
                # weight values — not necessarily the least-loaded SPU
                szs = g_size[gis]
                rep = np.repeat(np.arange(len(gis)), szs)
                syns_all = np.concatenate(
                    [syn_order[starts[gi]:starts[gi + 1]] for gi in gis])
                cw = np.zeros((len(gis), nw), np.int32)
                np.add.at(cw, (rep, w_id[syns_all]), 1)
                present = cw > 0
                gone = ((books.cnt_w[0, i] == cw) & present).sum(1)
                new = present.astype(np.int32) @ \
                    (books.cnt_w[0, spus] == 0).astype(np.int32).T
                q_g = post[syns_all[np.r_[0, np.cumsum(szs)[:-1]]]]
                no_q = (books.cnt_post[0][spus][:, q_g] == 0).T
                sc_i_new = cap - lines_of(
                    int(books.n_weights[0, i]) - gone,
                    int(books.n_posts[0, i]) - 1)            # [G]
                sc_j_new = cap - lines_of(
                    books.n_weights[0, spus][None, :] + new,
                    books.n_posts[0, spus][None, :] + no_q)  # [G, spc]
                d_over = (np.maximum(-sc_i_new, 0)[:, None]
                          - max(-int(scores[i]), 0)
                          + np.maximum(-sc_j_new, 0)
                          - np.maximum(-scores[spus], 0)[None, :])
                gap = load[i] - load[spus]                   # [spc]
                ok = ((d_over <= 0) & (2 * szs[:, None] <= gap[None, :])
                      & (spus[None, :] != i))
                if not ok.any():
                    continue
                gg, jj = np.nonzero(ok)
                # biggest group first, then emptiest receiver, then id
                pick = np.lexsort((spus[jj], load[spus[jj]], -szs[gg]))[0]
                gi, j = int(gis[gg[pick]]), int(spus[jj[pick]])
                sz = int(szs[gg[pick]])
                syns = syn_order[starts[gi]:starts[gi + 1]]
                q = int(post[syns[0]])
                sc_i = int(sc_i_new[gg[pick]])
                sc_j = int(sc_j_new[gg[pick], jj[pick]])
                books.move_group(0, syns, i, j)
                assign[syns] = j
                load[i] -= sz + (1 if books.cnt_post[0, i, q] == 0 else 0)
                load[j] += sz + (1 if books.cnt_post[0, j, q] == sz else 0)
                scores[i], scores[j] = sc_i, sc_j
                by_spu[i].remove(gi)
                by_spu[j].append(gi)
                g_spu[gi] = j
                stats["moves"] += 1
                moved = True
                break
            if not moved:
                break

    stats["max_load_after"] = int(load.max(initial=0))
    return assign, stats
