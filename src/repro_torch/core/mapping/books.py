"""Flat occupancy bookkeeping for the partition search (paper Eq. 9/10);
port of ``repro/core/mapping/books.py``.

Replaces the former per-SPU ``dict``/``set`` bookkeeping (``_Books`` in
the monolithic ``partition.py``) with dense numpy count arrays carrying
a leading restart dimension:

    cnt_post  [R, M, n_neurons]   synapses of post q on SPU i
    cnt_w     [R, M, n_wvals]     synapses with weight-id w on SPU i
    n_posts   [R, M]              unique posts stored per SPU
    n_weights [R, M]              unique weight values per SPU

Rebuilds after a perturbation are one ``np.bincount`` over the synapse
array; moves are O(group) slice updates; Eq. (10) scores are an O(M)
vectorized expression of ``n_posts``/``n_weights`` — no Python dict
churn anywhere on the search's hot path. Weight values are remapped to
dense ids once at construction (quantized weights span a few hundred
distinct values, so the count planes stay small).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig


@dataclasses.dataclass
class PartitionResult:
    assign: np.ndarray          # [E] synapse -> SPU
    scores: np.ndarray          # [M] final Eq. (10) scores
    feasible: bool
    iterations: int
    perturbations: int
    score_history: list         # mean score per iteration


class Books:
    """Batched per-SPU occupancy arrays over a restart population."""

    def __init__(self, g: SNNGraph, hw: HardwareConfig, assign: np.ndarray):
        """assign: ``[R, E]`` synapse -> SPU per restart."""
        assert assign.ndim == 2
        self.hw = hw
        self.post = g.post.astype(np.int64)
        self.w_vals, w_id = np.unique(g.weight, return_inverse=True)
        self.w_id = w_id.astype(np.int64)
        self.n_wvals = int(len(self.w_vals))
        self.n_neurons = int(g.n_neurons)
        r, m = assign.shape[0], hw.n_spus
        self.cnt_post = np.zeros((r, m, self.n_neurons), np.int32)
        self.cnt_w = np.zeros((r, m, self.n_wvals), np.int32)
        self.n_posts = np.zeros((r, m), np.int64)
        self.n_weights = np.zeros((r, m), np.int64)
        # presence counters: on how many SPUs does post q / weight w live?
        # (lets the search test "present on any better-scored SPU" as a
        # complement over the few worst SPUs instead of a plane reduction)
        self.np_post = np.zeros((r, self.n_neurons), np.int32)
        self.np_w = np.zeros((r, self.n_wvals), np.int32)
        for rr in range(r):
            self.rebuild(rr, assign[rr])

    # -- construction / perturbation ----------------------------------------

    def rebuild(self, rr: int, assign_r: np.ndarray) -> None:
        """Re-derive restart ``rr``'s occupancy from scratch (one bincount
        per plane — the O(E) ground-truth rebuild after a perturbation)."""
        m = self.hw.n_spus
        a = assign_r.astype(np.int64)
        self.cnt_post[rr] = np.bincount(
            a * self.n_neurons + self.post,
            minlength=m * self.n_neurons).reshape(m, self.n_neurons)
        self.cnt_w[rr] = np.bincount(
            a * self.n_wvals + self.w_id,
            minlength=m * self.n_wvals).reshape(m, self.n_wvals)
        self.n_posts[rr] = (self.cnt_post[rr] > 0).sum(1)
        self.n_weights[rr] = (self.cnt_w[rr] > 0).sum(1)
        self.np_post[rr] = (self.cnt_post[rr] > 0).sum(0)
        self.np_w[rr] = (self.cnt_w[rr] > 0).sum(0)

    # -- moves ---------------------------------------------------------------

    def move_group(self, rr: int, syns: np.ndarray, src: int, dst: int
                   ) -> None:
        """Move synapses ``syns`` (all sharing ONE post-neuron) src -> dst.

        Post counts are a scalar delta; weight counts are one bincount
        delta with unique-count maintenance — O(group + n_wvals), no
        per-synapse Python loop.
        """
        k = len(syns)
        if not k:
            return
        p = int(self.post[syns[0]])
        cp = self.cnt_post[rr]
        if cp[src, p] == k:
            self.n_posts[rr, src] -= 1
            self.np_post[rr, p] -= 1
        if cp[dst, p] == 0:
            self.n_posts[rr, dst] += 1
            self.np_post[rr, p] += 1
        cp[src, p] -= k
        cp[dst, p] += k

        wc = np.bincount(self.w_id[syns], minlength=self.n_wvals)
        moved = wc > 0
        cw_src, cw_dst = self.cnt_w[rr, src], self.cnt_w[rr, dst]
        gone = (cw_src == wc) & moved
        self.n_weights[rr, src] -= int(gone.sum())
        self.np_w[rr] -= gone
        cw_src -= wc
        new = (cw_dst == 0) & moved
        self.n_weights[rr, dst] += int(new.sum())
        self.np_w[rr] += new
        cw_dst += wc

    def move_one(self, rr: int, syn: int, src: int, dst: int) -> None:
        """Scalar fast path of :meth:`move_group` for single-synapse moves
        (the search's most common operation — no bincount, ~10 scalar
        updates)."""
        p, w = int(self.post[syn]), int(self.w_id[syn])
        cp, cw = self.cnt_post[rr], self.cnt_w[rr]
        c = cp[src, p]
        if c == 1:
            self.n_posts[rr, src] -= 1
            self.np_post[rr, p] -= 1
        if cp[dst, p] == 0:
            self.n_posts[rr, dst] += 1
            self.np_post[rr, p] += 1
        cp[src, p] = c - 1
        cp[dst, p] += 1
        c = cw[src, w]
        if c == 1:
            self.n_weights[rr, src] -= 1
            self.np_w[rr, w] -= 1
        if cw[dst, w] == 0:
            self.n_weights[rr, dst] += 1
            self.np_w[rr, w] += 1
        cw[src, w] = c - 1
        cw[dst, w] += 1

    # -- Eq. (10) ------------------------------------------------------------

    def scores_r(self, rr: int) -> np.ndarray:
        """[M] Eq. (10) scores: L - (ceil((|Q|+1)/K) + |P|)."""
        k, l = self.hw.concentration, self.hw.unified_mem_depth
        return l - (-(-(self.n_weights[rr] + 1) // k) + self.n_posts[rr])

    def scores(self) -> np.ndarray:
        """[R, M] scores for the whole population."""
        k, l = self.hw.concentration, self.hw.unified_mem_depth
        return l - (-(-(self.n_weights + 1) // k) + self.n_posts)

    def total_usage_r(self, rr: int) -> int:
        """Total memory lines used across SPUs (portfolio tie-breaker)."""
        k = self.hw.concentration
        return int((-(-(self.n_weights[rr] + 1) // k)
                    + self.n_posts[rr]).sum())
