"""Multilevel (coarsen–partition–refine) mapping for large graphs (§11/§12);
port of ``repro/core/mapping/multilevel.py``, bit for bit.

The framework search of :mod:`repro_torch.core.mapping.search` walks single
synapses and converges beautifully at paper scale (~33k synapses) but
not at the ROADMAP's 10⁵–10⁶-synapse target. This module wraps it
KaHyPar-style:

1. **Coarsen** — cluster post-neurons by greedy hyperedge-overlap
   matching: two posts that co-occur in many fan-out hyperedges (share
   many pre-neurons) are merged, so the multicast reuse the Multi-Cast
   Tree exploits is preserved INSIDE clusters and the coarse problem
   keeps the fine problem's traffic structure. Rounds of maximal
   matching shrink the synapse count geometrically until it reaches
   ``coarse_target``. Each round is pure array work (first-occurrence
   matching over the priority-ordered pair list — no per-edge Python
   loop), and the (pre, cluster) key set is carried ACROSS rounds, so
   only the first round ever touches the fine synapse list.
2. **Coarse seeds** — race a small candidate set of coarse
   partitionings: the direct greedy :func:`hypergraph_partition` on
   the coarse graph (candidate 0 — cheap and usually the winner:
   profile-guided measurement at the 10⁵ pinned shape showed the
   capped framework search costing ~2 s to produce a WORSE projection
   than the 0.02 s greedy) plus ``restarts - 1`` capped framework
   searches on distinct seeds. ``workers > 1`` fans the framework
   seeds out over processes; the reduction — lexicographic best
   (projected overflow, projected hop-weighted traffic, candidate
   index) — is computed in the parent and is worker-count-invariant.
3. **Project + place** — project the winning coarse assignment through
   the cluster map onto the fine synapses, then run the chip-placement
   stage (:func:`place_chips`): group SPUs onto chips by shared-pre
   affinity and place the chips on the 2D mesh so hop-weighted
   multicast traffic is small — making WHICH CHIP a group lands on an
   optimized dimension rather than an accident of SPU numbering
   (DESIGN.md §12).
4. **Refine** — FM boundary refinement of
   :func:`repro_torch.core.mapping.hypergraph.refine_mapping` against the
   real :class:`HardwareConfig` — Eq. (10) overflow first, then the
   multicast + mesh-hop traffic term — followed by the within-chip
   :func:`balance_loads` OT-depth pass. Refinement only accepts strict
   improvements, so the projected mapping never gets worse.

Each stage records itself on the active compile-phase profiler
(``coarsen`` / ``coarse_search`` / ``project`` / ``place`` /
``refine`` — see :mod:`repro_torch.core.profiling`).

Registered as the ``multilevel`` strategy; on graphs at or below
``coarse_target`` synapses it simply delegates to the direct
``hypergraph`` greedy (coarsening would be a no-op detour).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing as mp

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.mapping.hypergraph import (balance_loads,
                                           hypergraph_partition,
                                           mapping_traffic, mesh_hops,
                                           refine_mapping)
from repro_torch.core.mapping.search import framework_partition
from repro_torch.core.memory_model import HardwareConfig, scores_from_assignment
from repro_torch.core.profiling import phase

#: coarse problem size the framework search handles comfortably
COARSE_TARGET = 30_000


@dataclasses.dataclass(frozen=True)
class CoarseGraph:
    """A coarsened graph plus the maps back to the fine one."""
    graph: SNNGraph          # coarse posts are clusters of fine posts
    cluster: np.ndarray      # [n_internal] fine local post -> cluster id
    syn_map: np.ndarray      # [E_fine] fine synapse -> coarse synapse
    n_clusters: int
    levels: int


def _match_round(keys: np.ndarray, n_cl: int, sizes: np.ndarray,
                 edge_cap: int, size_cap: int) -> np.ndarray | None:
    """One maximal-matching round over hyperedge co-occurrence pairs.

    ``keys`` are the sorted unique (pre, cluster) pairs; consecutive
    clusters inside one pre's fan-out co-occur in that hyperedge, and
    the pair count over all (small) hyperedges is the overlap weight.
    A pair is matched iff it is the FIRST pair, in descending-overlap
    priority order, touching EITHER of its endpoints — the vectorized
    first-choice matching (two ``np.minimum.at`` first-occurrence
    scans, no per-pair Python loop); like any matching it never merges
    a cluster twice per round. Returns the merge map (cluster ->
    representative) or None when no pair can merge.
    """
    upre, ucl = keys // n_cl, keys % n_cl
    fanout = np.bincount(upre.astype(np.int64).astype(np.intp),
                         minlength=int(upre[-1]) + 1 if len(upre) else 1)
    same = upre[1:] == upre[:-1]
    small = fanout[upre[1:]] <= edge_cap
    a, b = ucl[:-1][same & small], ucl[1:][same & small]
    if not len(a):
        return None
    pk, counts = np.unique(a * n_cl + b, return_counts=True)
    order = np.lexsort((pk, -counts))
    x, y = pk[order] // n_cl, pk[order] % n_cl
    fits = sizes[x] + sizes[y] <= size_cap
    x, y = x[fits], y[fits]
    if not len(x):
        return None
    rank = np.arange(len(x), dtype=np.int64)
    first = np.full(n_cl, len(x), np.int64)
    np.minimum.at(first, x, rank)
    np.minimum.at(first, y, rank)
    take = (first[x] == rank) & (first[y] == rank)
    if not take.any():
        return None
    merge = np.arange(n_cl, dtype=np.int64)
    merge[y[take]] = x[take]
    return merge


def coarsen_graph(g: SNNGraph, hw: HardwareConfig, *,
                  coarse_target: int = COARSE_TARGET, edge_cap: int = 64,
                  size_cap: int | None = None, max_levels: int = 20
                  ) -> CoarseGraph:
    """Cluster posts by hyperedge overlap until the coarse synapse count
    reaches ``coarse_target`` (or matching stalls).

    ``size_cap`` bounds fine posts per cluster — a cluster lands whole
    on one SPU, where each fine post later costs one UM line, so the
    default keeps clusters well under the Eq. (9) depth. The unique
    (pre, cluster) key set — the coarse hyperedge view — is built once
    from the fine synapse list and then merged level-to-level, so each
    round costs O(coarse keys), not O(fine synapses).
    """
    if size_cap is None:
        size_cap = max(4, hw.unified_mem_depth // 4)
    m = hw.n_spus
    cluster = np.arange(g.n_internal, dtype=np.int64)
    sizes = np.ones(g.n_internal, np.int64)
    n_cl = g.n_internal
    levels = 0
    ck = cluster[g.post.astype(np.int64) - g.n_inputs]
    keys = np.unique(g.pre.astype(np.int64) * n_cl + ck)
    for _ in range(max_levels):
        if len(keys) <= coarse_target or n_cl <= 4 * m:
            break
        merge = _match_round(keys, n_cl, sizes, edge_cap, size_cap)
        if merge is None:
            break
        _, new_id = np.unique(merge, return_inverse=True)
        cluster = new_id[merge[cluster]]
        n_new = int(new_id.max()) + 1
        upre, ucl = keys // n_cl, keys % n_cl
        keys = np.unique(upre * n_new + new_id[merge[ucl]])
        n_cl = n_new
        sizes = np.bincount(cluster, minlength=n_cl).astype(np.int64)
        levels += 1

    # the coarse SNNGraph: every fine neuron may be a pre (coarse inputs
    # span them all); coarse posts are the clusters. Synapses dedup to
    # unique (pre, cluster); the representative weight is the fine weight
    # at the FIRST fine synapse of each coarse synapse (np.unique order —
    # deterministic), a stand-in that keeps the |Q| structure plausible.
    ck = cluster[g.post.astype(np.int64) - g.n_inputs]
    key = g.pre.astype(np.int64) * n_cl + ck
    ukey, first, syn_map = np.unique(key, return_index=True,
                                     return_inverse=True)
    gc = SNNGraph(
        n_inputs=g.n_neurons, n_neurons=g.n_neurons + n_cl,
        pre=(ukey // n_cl).astype(np.int32),
        post=(g.n_neurons + ukey % n_cl).astype(np.int32),
        weight=g.weight[first].astype(np.int32), lif=g.lif)
    return CoarseGraph(gc, cluster, syn_map.astype(np.int64), n_cl, levels)


def _coarse_depth(gc: SNNGraph, hw: HardwareConfig,
                  headroom: float = 1.15) -> int:
    """Memory depth for the coarse search: the balanced-usage estimate
    (posts spread evenly, every SPU holding the full weight alphabet)
    plus headroom. Real Eq. (9) feasibility is judged at the fine level."""
    nw = len(np.unique(gc.weight))
    per_spu = (-(-gc.n_internal // hw.n_spus)
               + -(-(nw + 1) // hw.concentration))
    return int(np.ceil(per_spu * headroom))


# ---------------------------------------------------------------------------
# Chip placement (DESIGN.md §12): which chip does a group land on?
# ---------------------------------------------------------------------------

def place_chips(g: SNNGraph, hw: HardwareConfig, assign: np.ndarray, *,
                max_sweeps: int = 8) -> np.ndarray:
    """Relabel SPUs so chip membership and mesh position improve.

    The mapper's SPU ids are logical; which PHYSICAL chip an SPU's
    subtree sits on — and where that chip sits on the 2D mesh — is free
    to choose, because a relabeling is a pure permutation: Eq. (9)/(10)
    scores, λ and the OT depth are untouched, only the mesh-hop traffic
    changes. This stage runs a deterministic QAP-style local search
    over SPU↔SPU swaps, starting from the CURRENT labeling (identity)
    and minimizing the pairwise proxy

        Σ_{i<j} A[i, j] · meshdist(chip(i), chip(j))

    with ``A[i, j]`` = pres held by both i and j (every shared pre
    whose SPUs land on distant chips stretches that multicast's mesh
    bounding box). The result is accepted only when the TRUE
    :func:`~repro_torch.core.mapping.hypergraph.mesh_hops` total strictly
    drops, so the stage can never lose to the §11 consecutive-id
    grouping it starts from. Identity at ``n_chips=1``.
    """
    m, spc, c = hw.n_spus, hw.spus_per_chip, hw.n_chips
    if c == 1:
        return assign
    pres = np.zeros((m, g.n_neurons), np.float32)
    pres[assign.astype(np.int64), g.pre.astype(np.int64)] = 1.0
    aff = (pres @ pres.T).astype(np.int64)               # [M, M] shared pres
    np.fill_diagonal(aff, 0)
    slots = np.arange(c)
    dist = hw.chip_hops(slots[:, None], slots[None, :]).astype(np.int64)

    perm = np.arange(m, dtype=np.int64)                  # old spu -> new
    chip = perm // spc                                   # [M] chip of spu
    for _ in range(max_sweeps):
        improved = False
        for i in range(m):
            for j in range(i + 1, m):
                a_c, b_c = int(chip[i]), int(chip[j])
                if a_c == b_c:
                    continue
                # QAP swap delta: mutual term is symmetric-invariant,
                # the k∈{i,j} cross terms cancel out of the k-sum
                dd = dist[b_c, chip] - dist[a_c, chip]
                delta = int(((aff[i] - aff[j]) * dd).sum()) \
                    + 2 * int(aff[i, j]) * int(dist[a_c, b_c])
                if delta < 0:
                    perm[i], perm[j] = perm[j], perm[i]
                    chip[i], chip[j] = chip[j], chip[i]
                    improved = True
        if not improved:
            break

    out = perm[assign.astype(np.int64)].astype(np.int32)
    if int(mesh_hops(g, out, hw).sum()) < int(mesh_hops(g, assign,
                                                        hw).sum()):
        return out
    return assign


# ---------------------------------------------------------------------------
# Raced coarse seeds.
# ---------------------------------------------------------------------------

def _framework_seed(gc: SNNGraph, hwc: HardwareConfig, seed: int,
                    max_iters: int) -> tuple[np.ndarray, int, int]:
    """One capped framework search on the coarse graph (process-safe)."""
    res, _, _ = framework_partition(gc, hwc, seed=seed,
                                    max_iters=max_iters)
    return res.assign, res.iterations, res.perturbations


def _projected_quality(g: SNNGraph, hw: HardwareConfig,
                       fine_assign: np.ndarray) -> tuple[int, int]:
    """(overflow lines, hop-weighted traffic) of a projected mapping —
    the deterministic coarse-seed reduction key."""
    scores = scores_from_assignment(g.weight, g.post, fine_assign, hw)
    overflow = int(np.maximum(-scores, 0).sum())
    t = mapping_traffic(g, fine_assign, hw)
    hop = hw.inter_chip_hop_cycles if hw.n_chips > 1 else 0
    return overflow, t["dests_total"] + hop * t["mesh_hops_total"]


def multilevel_partition(g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                         max_iters: int = 20000, restarts: int = 1,
                         workers: int = 1,
                         coarse_target: int = COARSE_TARGET,
                         edge_cap: int = 64, size_cap: int | None = None,
                         refine_passes: int = 4,
                         chip_placement: bool = True) -> PartitionResult:
    """Coarsen – race coarse seeds – project – place – refine.

    Graphs at or below ``coarse_target`` synapses go straight to the
    direct greedy :func:`hypergraph_partition`. Above it, the coarse
    candidates are the greedy overlap partitioner plus ``restarts - 1``
    capped framework searches (distinct seeds); ``workers > 1`` runs
    the framework seeds in parallel processes, and the best-of
    reduction — lexicographic (projected overflow, projected
    hop-weighted traffic, candidate index) — is evaluated in the parent
    so the result is identical for ANY worker count.
    ``chip_placement=False`` skips the mesh placement stage (the §11
    consecutive-id chain overlay; kept for the counterfactual bench
    row).
    """
    if g.n_synapses <= coarse_target:
        return hypergraph_partition(g, hw, seed=seed,
                                    refine_passes=refine_passes)

    with phase("coarsen"):
        cg = coarsen_graph(g, hw, coarse_target=coarse_target,
                           edge_cap=edge_cap, size_cap=size_cap)
    hwc = dataclasses.replace(hw, unified_mem_depth=_coarse_depth(cg.graph,
                                                                  hw))

    with phase("coarse_search"):
        iters = min(max_iters, 5000)
        greedy = hypergraph_partition(cg.graph, hwc, seed=seed)
        seeds = [(greedy.assign, greedy.iterations, 0)]
        n_fw = max(restarts - 1, 0)
        if n_fw and workers > 1:
            ctx = mp.get_context("spawn")
            with cf.ProcessPoolExecutor(
                    max_workers=min(workers, n_fw),
                    mp_context=ctx) as pool:
                futs = [pool.submit(_framework_seed, cg.graph, hwc,
                                    seed + k, iters)
                        for k in range(n_fw)]
                seeds += [f.result() for f in futs]
        else:
            seeds += [_framework_seed(cg.graph, hwc, seed + k, iters)
                      for k in range(n_fw)]

    with phase("project"):
        projected = [a[cg.syn_map].astype(np.int32) for a, _, _ in seeds]
        best = min(range(len(projected)),
                   key=lambda i: (*_projected_quality(g, hw, projected[i]),
                                  i))
    assign = projected[best]
    c_iters, c_perturb = seeds[best][1], seeds[best][2]

    with phase("refine"):
        assign, stats = refine_mapping(g, hw, assign, passes=refine_passes)
        assign, bstats = balance_loads(g, hw, assign)

    if chip_placement and hw.n_chips > 1:
        # final re-placement: the refiner/balancer moved groups, so
        # re-solve the (pure relabeling) chip grouping + mesh placement
        # for the FINAL per-SPU contents; place_chips accepts only on
        # strictly fewer true mesh hops, so this can never lose to the
        # consecutive-id grouping it starts from
        with phase("place"):
            assign = place_chips(g, hw, assign)
    scores = scores_from_assignment(g.weight, g.post, assign, hw)
    return PartitionResult(assign, scores, bool(scores.min() >= 0),
                           c_iters + stats.moves + bstats["moves"],
                           c_perturb, [])
