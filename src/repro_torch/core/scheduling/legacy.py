"""The original Python scheduling loop, preserved as the parity reference;
port of ``repro/core/scheduling/legacy.py``.

This is the seed repo's ``schedule.py`` heuristic (paper §6.3), kept
verbatim: per-post/per-SPU ``cum`` recurrence, dict-of-groups, per-group
``bisect`` backward fill, reverse Pre-End scan. The vectorized core in
:mod:`repro_torch.core.scheduling.vectorized` must reproduce it BIT-EXACTLY —
same tables, same ``send_slot``/``send_order``, same infeasibility
assertion messages — for any (graph, assignment, hw, send order);
``tests/test_torch_compile.py`` holds both to the reference's.

Two injection hooks were added for strategy parity testing (they default
to the original behavior and leave the loop itself untouched):

* ``send_order`` — an externally-chosen post transmit order (what a
  :class:`~repro_torch.core.scheduling.strategies.ScheduleStrategy` produces);
  ``None`` computes the original ascending max-synapses-per-SPU order.
* ``send_slots`` — externally-chosen post -> slot assignments, replacing
  the feasibility recurrence entirely (the backward fill can then run
  out of room, exercising the infeasibility assertion).

Do not optimize this module; its value is being the slow, obviously-
faithful spine the fast path is proven against.
"""
from __future__ import annotations

import bisect

import numpy as np

from repro_torch.core.graph import SNNGraph
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.core.scheduling.tables import NOP, OpTables


def schedule_legacy(g: SNNGraph, assign: np.ndarray, hw: HardwareConfig,
                    send_order: list | np.ndarray | None = None,
                    send_slots: dict[int, int] | None = None) -> OpTables:
    """The original loop-based scheduler (see module docstring).

    Algorithm (faithful to the paper, plus an explicit send-slot
    recurrence that guarantees backward-fill feasibility):

      1. Sort post-neurons ascending by max-synapses-on-any-single-SPU
         (high-fan-in posts transmit last, maximizing slack).
      2. Walk the sorted order keeping per-SPU cumulative op counts
         cum_i; post p gets send slot t_p = max(t_prev + 1,
         max_i cum_i(p) - 1). (The paper uses consecutive slots, which
         suffices when #posts >= per-SPU load; the max() generalizes it
         — with balanced load the depth converges to max_i(total
         ops_i), exactly the paper's Fig. 13 regime.)
      3. Fix one synapse of each (SPU, post) group at t_p with Post-End
         set.
      4. Backward-fill the remaining synapses into free earlier slots,
         processing posts in REVERSE send order (EDF-style; provably
         feasible given the recurrence in 2).
      5. Set Pre-End on the last op referencing each pre-synaptic
         neuron.
      6. Remaining slots are NOPs.
    """
    m = hw.n_spus

    # group synapses by (spu, post)
    order = np.lexsort((g.pre, g.post, assign))
    s_spu, s_post = assign[order], g.post[order]

    posts = np.unique(g.post)
    # count per (spu, post): c[spu][post]
    group_keys = s_spu.astype(np.int64) * g.n_neurons + s_post
    uniq_keys, key_start, key_count = np.unique(
        group_keys, return_index=True, return_counts=True)

    # per-post max count over SPUs (step 1)
    post_of_key = (uniq_keys % g.n_neurons).astype(np.int64)
    cmax: dict[int, int] = {}
    for pk, c in zip(post_of_key.tolist(), key_count.tolist()):
        cmax[pk] = max(cmax.get(pk, 0), int(c))
    if send_order is None:
        send_order = sorted(posts.tolist(), key=lambda q: (cmax[q], q))
    else:
        send_order = [int(q) for q in send_order]

    # step 2: send slots via the feasibility recurrence
    groups: dict[tuple[int, int], np.ndarray] = {}
    for k, st, c in zip(uniq_keys.tolist(), key_start.tolist(),
                        key_count.tolist()):
        spu, pq = int(k // g.n_neurons), int(k % g.n_neurons)
        groups[(spu, pq)] = order[st:st + c]

    if send_slots is None:
        cum = np.zeros(m, np.int64)
        send_slot: dict[int, int] = {}
        t_prev = -1
        for pq in send_order:
            for spu in range(m):
                grp = groups.get((spu, pq))
                if grp is not None:
                    cum[spu] += len(grp)
            t = max(t_prev + 1, int(cum.max()) - 1)
            send_slot[pq] = t
            t_prev = t
        depth = t_prev + 1 if send_order else 0
    else:
        send_slot = {int(q): int(t) for q, t in send_slots.items()}
        send_order = sorted(send_slot, key=send_slot.__getitem__)
        depth = max(send_slot.values()) + 1 if send_slot else 0

    pre_t = np.full((m, depth), NOP, np.int64)
    post_t = np.full((m, depth), NOP, np.int64)
    w_t = np.zeros((m, depth), np.int64)
    pe_t = np.zeros((m, depth), bool)
    poe_t = np.zeros((m, depth), bool)

    # step 3: pin final synapse of every (spu, post) group at t_p
    for (spu, pq), grp in groups.items():
        t = send_slot[pq]
        syn = int(grp[-1])
        pre_t[spu, t] = g.pre[syn]
        post_t[spu, t] = pq
        w_t[spu, t] = g.weight[syn]
        poe_t[spu, t] = True

    # free-slot lists per SPU (ascending), minus the pinned send slots
    free = []
    for spu in range(m):
        pinned = {int(send_slot[pq]) for (s, pq) in groups if s == spu}
        free.append([t for t in range(depth) if t not in pinned])

    # step 4: backward fill, reverse send order
    for pq in reversed(send_order):
        t_p = send_slot[pq]
        for spu in range(m):
            grp = groups.get((spu, pq))
            if grp is None or len(grp) == 1:
                continue
            rest = grp[:-1]
            fl = free[spu]
            # indices of free slots strictly before t_p
            hi = bisect.bisect_left(fl, t_p)
            assert hi >= len(rest), (
                f"schedule infeasible: SPU {spu} post {pq} needs "
                f"{len(rest)} slots before {t_p}, has {hi}")
            take = fl[hi - len(rest):hi]
            del fl[hi - len(rest):hi]
            for t, syn in zip(take, rest.tolist()):
                pre_t[spu, t] = g.pre[syn]
                post_t[spu, t] = pq
                w_t[spu, t] = g.weight[syn]

    # step 5: Pre-End on the last op touching each pre, per SPU
    for spu in range(m):
        seen: set[int] = set()
        for t in range(depth - 1, -1, -1):
            pr = int(pre_t[spu, t])
            if pr != NOP and pr not in seen:
                pe_t[spu, t] = True
                seen.add(pr)

    return OpTables(depth, pre_t, post_t, w_t, pe_t, poe_t,
                    send_slot, send_order, assign.astype(np.int32))
