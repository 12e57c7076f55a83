"""Vectorized heuristic scheduling (paper §6.3); port of
``repro/core/scheduling/vectorized.py`` (numpy), the same array code so
the tables are the reference's bit for bit.

Every step works on ALL (SPU, post) groups at once:

* steps 1-2: the per-post send-slot recurrence
  ``t_p = max(t_prev + 1, max_i cum_i(p) - 1)`` has the closed form
  ``t_i = i + max(0, running_max(a_j - j))`` with
  ``a_j = max_i cum_i(j) - 1``, one ``cumsum`` + ``maximum.accumulate``
  over the [P, M] count matrix;
* step 3: the final synapse of every group is pinned at its send slot;
* step 4: the backward fill processes groups by descending send slot,
  each taking the largest still-free slots below its deadline; the
  per-group offsets ``e_q = max(e_{q-1}, a_q) + r_q`` (``a_q`` free
  slots at or above the deadline, ``r_q`` the group's demand) have the
  closed form ``e_q = R_q + max_{k<=q}(a_k - R_{k-1})``, evaluated for
  every SPU at once with a segmented-offset trick;
* step 5: Pre-End flags go on the last op per (SPU, pre).

An infeasible fill raises ``AssertionError`` with the reference's
message for the first violation in its processing order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling.tables import NOP, OpTables


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """The (SPU, post) grouping of an assignment, shared by the slot
    recurrence, the backward fill, and every
    :class:`~repro_torch.core.scheduling.strategies.ScheduleStrategy` (which
    orders posts from the per-post statistics without regrouping)."""
    order: np.ndarray        # [E] synapse ids lexsorted by (spu, post, pre)
    key_start: np.ndarray    # [G] group start offsets into ``order``
    key_count: np.ndarray    # [G] group sizes
    spu_of_key: np.ndarray   # [G] SPU of each group
    post_of_key: np.ndarray  # [G] post of each group
    posts: np.ndarray        # [P] unique posts, ascending
    cmax: np.ndarray         # [P] max synapses of the post on any one SPU
    total: np.ndarray        # [P] total synapses of the post


def group_info(g: SNNGraph, assign: np.ndarray) -> GroupInfo:
    """Group synapses by (SPU, post) and derive per-post statistics.

    One argsort on the combined (spu, post, pre) key — unique per
    synapse, so even the unstable default sort reproduces the legacy
    ``lexsort((pre, post, assign))`` order at a third of the sort
    passes — with group boundaries read off the sorted key instead of
    a second sort inside ``np.unique``.
    """
    n = np.int64(g.n_neurons)
    key = (assign.astype(np.int64) * n + g.post) * n + g.pre
    # keys are unique per synapse (SNNGraph.validate: no duplicate
    # (pre, post) pairs), so the unstable default sort is deterministic
    # and equals the legacy stable lexsort order
    order = np.argsort(key)
    gkey = key[order] // n                      # (spu, post) group key
    first = np.r_[np.ones(min(len(gkey), 1), bool), gkey[1:] != gkey[:-1]]
    key_start = np.flatnonzero(first)
    key_count = np.diff(np.r_[key_start, len(gkey)])
    uniq = gkey[key_start] if len(key_start) else gkey[:0]
    spu_of_key = uniq // n
    post_of_key = uniq % n

    posts = np.unique(g.post).astype(np.int64)
    pidx = np.searchsorted(posts, post_of_key)
    cmax = np.zeros(len(posts), np.int64)
    np.maximum.at(cmax, pidx, key_count)
    total = np.zeros(len(posts), np.int64)
    np.add.at(total, pidx, key_count)
    return GroupInfo(order, key_start, key_count, spu_of_key, post_of_key,
                     posts, cmax, total)


def slack_send_order(info: GroupInfo) -> np.ndarray:
    """The legacy default order: ascending (max-synapses-per-SPU, post)."""
    return info.posts[np.lexsort((info.posts, info.cmax))]


def schedule_vectorized(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig,
                        send_order: np.ndarray | list | None = None,
                        send_slots: dict[int, int] | None = None,
                        info: GroupInfo | None = None) -> OpTables:
    """Array-core scheduler, bit-exact with the reference's.

    ``send_order``/``send_slots`` inject an externally-chosen post
    transmit order, or externally-chosen post -> slot assignments
    replacing the recurrence. ``info`` takes a precomputed :func:`group_info` so
    multi-strategy callers (the portfolio) group only once.
    """
    m = hw.n_spus
    gi = info if info is not None else group_info(g, assign)
    posts = gi.posts
    n = g.n_neurons

    # -- steps 1-2: send order + send slots ---------------------------------
    if send_slots is not None:
        so = np.asarray(sorted(send_slots, key=send_slots.__getitem__),
                        np.int64)
        if not np.array_equal(np.sort(so), posts):
            raise ValueError("send_slots must assign a slot to every "
                             "post-neuron of the graph")
        t = np.array([send_slots[int(q)] for q in so], np.int64)
    else:
        if send_order is None:
            so = slack_send_order(gi)
        else:
            so = np.asarray(send_order, np.int64)
            if not np.array_equal(np.sort(so), posts):
                raise ValueError("send_order must be a permutation of the "
                                 "graph's post-neurons")
        p_n = len(so)
        rank = np.full(n, -1, np.int64)
        rank[so] = np.arange(p_n)
        cum = np.zeros((p_n, m), np.int64)
        cum[rank[gi.post_of_key], gi.spu_of_key] = gi.key_count
        a = np.cumsum(cum, 0).max(1) - 1 if p_n else np.zeros(0, np.int64)
        idx = np.arange(p_n)
        t = idx + np.maximum(np.maximum.accumulate(a - idx), 0) if p_n \
            else np.zeros(0, np.int64)
    depth = int(t[-1]) + 1 if len(so) else 0
    send_order_l = [int(q) for q in so]
    send_slot = {q: int(tt) for q, tt in zip(send_order_l, t)}

    slot_of_post = np.full(n, -1, np.int64)
    slot_of_post[so] = t
    t_of_key = slot_of_post[gi.post_of_key]

    pre_t = np.full((m, depth), NOP, np.int64)
    post_t = np.full((m, depth), NOP, np.int64)
    w_t = np.zeros((m, depth), np.int64)
    pe_t = np.zeros((m, depth), bool)
    poe_t = np.zeros((m, depth), bool)
    if not len(so):
        return OpTables(depth, pre_t, post_t, w_t, pe_t, poe_t,
                        send_slot, send_order_l, assign.astype(np.int32))

    # -- step 3: pin the final synapse of every group at its send slot ------
    last_syn = gi.order[gi.key_start + gi.key_count - 1]
    pin_pre = g.pre[last_syn].astype(np.int64)
    pre_t[gi.spu_of_key, t_of_key] = pin_pre
    post_t[gi.spu_of_key, t_of_key] = gi.post_of_key
    w_t[gi.spu_of_key, t_of_key] = g.weight[last_syn]
    poe_t[gi.spu_of_key, t_of_key] = True

    # dense last-reference plane for step 5, fed as ops are produced
    last_ref = np.full(m * n, -1, np.int64)     # (spu, pre) -> max slot
    np.maximum.at(last_ref, gi.spu_of_key * n + pin_pre, t_of_key)

    # per-SPU free slots, ascending: everything not pinned (poe_t IS the
    # pinned mask — one Post-End per group, groups pin distinct slots)
    f_spu, f_slot = np.nonzero(~poe_t)          # row-major: spu, then slot
    nf = (~poe_t).sum(1)
    f_start = np.concatenate([[0], np.cumsum(nf)])

    # -- step 4: backward fill, descending send slots, per SPU --------------
    sel = gi.key_count >= 2
    if sel.any():
        # groups in legacy processing order per SPU: descending send slot
        gs = np.flatnonzero(sel)
        ordk = np.lexsort((-t_of_key[gs], gi.spu_of_key[gs]))
        gs = gs[ordk]
        gs_spu = gi.spu_of_key[gs]
        gs_post = gi.post_of_key[gs]
        gs_t = t_of_key[gs]
        gs_r = gi.key_count[gs] - 1             # backward-fill demand
        gs_begin = gi.key_start[gs]

        # a_q: free slots at-or-above the deadline on the group's SPU
        f_key = f_spu.astype(np.int64) * depth + f_slot
        pos = np.searchsorted(f_key, gs_spu * np.int64(depth) + gs_t)
        a_free = f_start[gs_spu + 1] - pos

        # e_q = max(e_{q-1}, a_q) + r_q  per SPU  ==  segment-local
        # R_q + running_max(a_q - R_{q-1}), via the offset trick
        cum_r = np.cumsum(gs_r)
        seg_first = np.r_[True, gs_spu[1:] != gs_spu[:-1]]
        seg_base = np.maximum.accumulate(
            np.where(seg_first, cum_r - gs_r, 0))
        r_loc = cum_r - seg_base
        big = np.int64(depth + g.n_synapses + 2)
        run = np.maximum.accumulate(a_free - (r_loc - gs_r) + gs_spu * big)
        e = r_loc + run - gs_spu * big
        s = e - gs_r

        bad = e > nf[gs_spu]
        if bad.any():
            # the first violation the legacy loop would hit: outermost
            # reverse send order, innermost ascending SPU
            vi = np.flatnonzero(bad)
            first = vi[np.lexsort((gs_spu[vi], -gs_t[vi]))[0]]
            spu_b = int(gs_spu[first])
            raise AssertionError(
                f"schedule infeasible: SPU {spu_b} post "
                f"{int(gs_post[first])} needs {int(gs_r[first])} slots "
                f"before {int(gs_t[first])}, has "
                f"{int(nf[spu_b] - s[first])}")

        # expand per-group [nf-e, nf-s) windows of the per-SPU free array
        # into per-op scatters; window j pairs with rest synapse j
        gidx = np.repeat(np.arange(len(gs_r)), gs_r)
        within = np.arange(int(cum_r[-1])) - np.repeat(cum_r - gs_r, gs_r)
        fpos = (f_start[gs_spu] + nf[gs_spu] - e)[gidx] + within
        fill_slot = f_slot[fpos]
        fill_syn = gi.order[gs_begin[gidx] + within]
        fill_spu = gs_spu[gidx]
        fill_pre = g.pre[fill_syn].astype(np.int64)
        pre_t[fill_spu, fill_slot] = fill_pre
        post_t[fill_spu, fill_slot] = g.post[fill_syn]
        w_t[fill_spu, fill_slot] = g.weight[fill_syn]
        np.maximum.at(last_ref, fill_spu * n + fill_pre, fill_slot)

    # -- step 5: Pre-End on the last op touching each (SPU, pre) ------------
    ref = np.flatnonzero(last_ref >= 0)
    pe_t[ref // n, last_ref[ref]] = True

    return OpTables(depth, pre_t, post_t, w_t, pe_t, poe_t,
                    send_slot, send_order_l, assign.astype(np.int32))
