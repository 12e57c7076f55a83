"""The original pure-Python partition loop, preserved as the reference;
port of ``repro/core/mapping/legacy.py``.

This is the seed repo's ``partition.py`` rebalancing loop (paper §6.2
with the recorded deviations of DESIGN.md §8), kept verbatim except for
ONE canonicalization: per-SPU membership is iterated in ascending
synapse-index order instead of CPython-set hash order. Set order was
implementation-defined (and impossible to reproduce from array code);
index order is a well-defined draw from the same distribution. With
that order pinned, the vectorized core in :mod:`.search` consumes the
identical RNG stream and must reproduce this loop's assignment
BIT-EXACTLY for any (graph, hw, seed); ``tests/test_torch_mapping.py``
holds both to the reference's.

Do not optimize this module; its value is being the slow, obviously-
faithful spine the fast path is proven against.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.mapping.books import PartitionResult
from repro_torch.core.memory_model import HardwareConfig


def _walk(p: np.ndarray, r: np.ndarray, depth: int) -> np.ndarray:
    """Route every synapse through the tree. p, r: [M-1, E]."""
    e = p.shape[1]
    idx = np.arange(e)
    prefix = np.zeros(e, np.int64)
    for d in range(depth):
        sw = (1 << d) - 1 + prefix
        go_right = r[sw, idx] >= p[sw, idx]
        prefix = (prefix << 1) | go_right
    return prefix.astype(np.int32)


def _leaf_path(leaf: int, depth: int) -> list[tuple[int, int]]:
    """[(switch_heap_index, side)] from root to leaf; side 0=left, 1=right."""
    path = []
    prefix = 0
    for d in range(depth):
        side = (leaf >> (depth - 1 - d)) & 1
        path.append(((1 << d) - 1 + prefix, side))
        prefix = (prefix << 1) | side
    return path


class _Books:
    """Incremental per-SPU occupancy + global post/weight location maps."""

    def __init__(self, g: SNNGraph, assign: np.ndarray, hw: HardwareConfig):
        m = hw.n_spus
        self.hw = hw
        self.g = g
        self.cnt_post = [dict() for _ in range(m)]
        self.cnt_w = [dict() for _ in range(m)]
        self.syn_of = [set() for _ in range(m)]
        self.post_locs: dict[int, set[int]] = {}
        self.w_locs: dict[int, set[int]] = {}
        for s, spu in enumerate(assign):
            self._add(int(spu), s)

    def _add(self, spu: int, syn: int):
        p, w = int(self.g.post[syn]), int(self.g.weight[syn])
        self.cnt_post[spu][p] = self.cnt_post[spu].get(p, 0) + 1
        if self.cnt_post[spu][p] == 1:
            self.post_locs.setdefault(p, set()).add(spu)
        self.cnt_w[spu][w] = self.cnt_w[spu].get(w, 0) + 1
        if self.cnt_w[spu][w] == 1:
            self.w_locs.setdefault(w, set()).add(spu)
        self.syn_of[spu].add(syn)

    def _del(self, spu: int, syn: int):
        p, w = int(self.g.post[syn]), int(self.g.weight[syn])
        self.cnt_post[spu][p] -= 1
        if not self.cnt_post[spu][p]:
            del self.cnt_post[spu][p]
            self.post_locs[p].discard(spu)
        self.cnt_w[spu][w] -= 1
        if not self.cnt_w[spu][w]:
            del self.cnt_w[spu][w]
            self.w_locs[w].discard(spu)
        self.syn_of[spu].remove(syn)

    def move(self, syn: int, src: int, dst: int):
        self._del(src, syn)
        self._add(dst, syn)

    def scores(self) -> np.ndarray:
        k, l = self.hw.concentration, self.hw.unified_mem_depth
        return np.array([
            l - (math.ceil((len(cw) + 1) / k) + len(cp))
            for cw, cp in zip(self.cnt_w, self.cnt_post)], np.int64)

    def total_usage(self) -> int:
        k = self.hw.concentration
        return sum(math.ceil((len(cw) + 1) / k) + len(cp)
                   for cw, cp in zip(self.cnt_w, self.cnt_post))


def partition_legacy(g: SNNGraph, hw: HardwareConfig, *, seed: int = 0,
                     max_iters: int = 50000, eta: float = 0.25,
                     move_mode: str = "decisive",
                     stagnation_window: int = 300, cooldown: int = 64,
                     scan_cap: int = 384,
                     ) -> PartitionResult:
    m, depth, e = hw.n_spus, hw.tree_depth, g.n_synapses
    rng = np.random.default_rng(seed)
    p = np.full((m - 1, e), 0.5, np.float64)
    r = rng.random((m - 1, e))

    posts, weights = g.post, g.weight
    assign = _walk(p, r, depth)
    books = _Books(g, assign, hw)
    scores = books.scores()

    history: list[float] = []
    moved_at = np.full(e, -(1 << 30), np.int64)
    perturbations = 0
    best_min = int(scores.min())
    best_total = books.total_usage()
    best_state = (assign.copy(), scores.copy())
    last_improve = 0

    def note_progress(it):
        """Track (worst score, global line usage) improvements."""
        nonlocal best_min, best_total, best_state, last_improve
        mn, tot = int(scores.min()), books.total_usage()
        if mn > best_min:
            best_min = mn
            best_state = (assign.copy(), scores.copy())
            last_improve = it
        if tot < best_total:
            best_total = tot
            last_improve = it

    def perturb(it):
        nonlocal assign, books, scores, perturbations, last_improve
        # reflective boundaries: stay uniform, preserve locality
        rr = r + rng.uniform(-0.1, 0.1, r.shape)
        rr = np.where(rr < 0.0, -rr, rr)
        rr = np.where(rr > 1.0, 2.0 - rr, rr)
        r[:] = rr
        perturbations += 1
        last_improve = it
        assign = _walk(p, r, depth)
        books = _Books(g, assign, hw)
        scores = books.scores()
        note_progress(it)

    for it in range(max_iters):
        if scores.min() >= 0:
            return PartitionResult(assign, scores, True, it, perturbations,
                                   history)
        history.append(float(scores.mean()))

        # --- stagnation: no worst-score progress in the window -> shake ---
        if it - last_improve >= stagnation_window:
            perturb(it)
            continue

        # --- pick overloaded SPU and a synapse to evict ---
        ov = int(scores.argmin())
        better = scores > scores[ov]
        better[ov] = False
        better_set = set(np.flatnonzero(better).tolist())
        cnt_post, cnt_w = books.cnt_post[ov], books.cnt_w[ov]
        best_rank, cands = (9,), []
        members = sorted(books.syn_of[ov])     # canonical index order
        if len(members) > scan_cap:
            # rank a random sample — at 30k+ synapses the full scan is the
            # per-iteration cost; eviction quality is rank-based, and a
            # 384-sample preserves the rank distribution (DESIGN.md §8)
            members = [members[i] for i in
                       rng.choice(len(members), scan_cap, replace=False)]
        for s in members:
            if it - moved_at[s] < cooldown:
                continue
            sp_, sw_ = int(posts[s]), int(weights[s])
            pu = cnt_post[sp_] == 1
            pa = not better_set.isdisjoint(books.post_locs.get(sp_, ()))
            wu = cnt_w[sw_] == 1
            wa = not better_set.isdisjoint(books.w_locs.get(sw_, ()))
            rank = (not pu, not pa, not wu, not wa)
            if rank < best_rank:
                best_rank, cands = rank, [s]
            elif rank == best_rank:
                cands.append(s)
        if not cands:        # everything in ov is cooling down; shake
            perturb(it)
            continue
        syn = int(cands[rng.integers(len(cands))])
        sp, sw_val = int(posts[syn]), int(weights[syn])

        # --- destination by 4-level priority among higher-scored SPUs ---
        has_post = np.zeros(m, bool)
        has_post[list(books.post_locs.get(sp, ()))] = True
        has_w = np.zeros(m, bool)
        has_w[list(books.w_locs.get(sw_val, ()))] = True
        # equal-scored SPUs are acceptable only for *consolidating* moves
        # (post/weight already present there -> net line-usage decrease);
        # this matters under tight constraints where every SPU is equally
        # overloaded and no strictly-better destination exists.
        equal = scores == scores[ov]
        equal[ov] = False
        dst = None
        for mask in (better & has_post & has_w, better & has_post,
                     better & has_w, equal & has_post & has_w,
                     equal & has_post, better, equal & has_w):
            if mask.any():
                idxs = np.flatnonzero(mask)
                dst = int(idxs[np.argmax(scores[idxs])])
                break
        if dst is None:  # nowhere productive to move; shake and retry
            perturb(it)
            continue

        # --- adjust probabilities along both paths below the LCA ---
        # (routing goes LEFT when R < P, so P is P(left))
        path_ov = _leaf_path(ov, depth)
        path_dst = _leaf_path(dst, depth)
        lca = 0
        while lca < depth and path_ov[lca] == path_dst[lca]:
            lca += 1
        for sw, side in path_ov[lca:]:
            # make the branch toward `ov` less likely
            p[sw, syn] += -eta if side == 0 else eta
        if move_mode == "decisive":
            # land exactly in dst: put P just past R on its path
            for sw, side in path_dst[lca:]:
                if side == 0:   # need LEFT: R < P
                    p[sw, syn] = min(1.0, r[sw, syn] + eta)
                else:           # need RIGHT: R >= P
                    p[sw, syn] = max(0.0, r[sw, syn] - eta)
        else:
            for sw, side in path_dst[lca:]:
                p[sw, syn] += eta if side == 0 else -eta
        np.clip(p[:, syn], 0.0, 1.0, out=p[:, syn])

        # --- re-route the synapse (only its own entries changed) ---
        if move_mode == "decisive":
            new_spu = dst
        else:
            prefix = 0
            for d in range(depth):
                sw = (1 << d) - 1 + prefix
                prefix = (prefix << 1) | int(r[sw, syn] >= p[sw, syn])
            new_spu = int(prefix)
        if new_spu != assign[syn]:
            books.move(syn, int(assign[syn]), new_spu)
            assign[syn] = new_spu
            moved_at[syn] = it
            # POST-GROUP BURST: once the post exists in dst, every further
            # synapse of (ov, post) ranks dst first under the paper's
            # priority order — fast-forward those consecutive single moves
            # (large instances never consolidate otherwise; DESIGN.md §8)
            if move_mode == "decisive" and new_spu == dst:
                rest = [s2 for s2 in sorted(books.syn_of[ov])
                        if int(posts[s2]) == sp]
                for s2 in rest:
                    for sw, side in path_ov[lca:]:
                        p[sw, s2] += -eta if side == 0 else eta
                    for sw, side in path_dst[lca:]:
                        if side == 0:
                            p[sw, s2] = min(1.0, r[sw, s2] + eta)
                        else:
                            p[sw, s2] = max(0.0, r[sw, s2] - eta)
                    np.clip(p[:, s2], 0.0, 1.0, out=p[:, s2])
                    books.move(int(s2), ov, dst)
                    assign[s2] = dst
                    moved_at[s2] = it
            scores = books.scores()
            note_progress(it)

    assign, scores = best_state
    return PartitionResult(assign, scores, bool(scores.min() >= 0),
                           max_iters, perturbations, history)
