"""Schedule hazard detector; port of ``repro/analysis/schedule.py``.

Re-derives send-slot occupancy from the raw ``[M, depth]`` tables and
proves the paper's scheduling contract without executing any engine:

* every synapse appears exactly once (SCHED001/002);
* Merge-Tree alignment: every Post-End op of post ``p`` sits in ``p``'s
  one send slot (SCHED003/004/005);
* the send-slot deadline: no op of ``p`` after its send slot (SCHED006);
* Pre-End marks exactly the last reference per (SPU, pre) (SCHED007);
* one send per slot (SCHED008);
* table well-formedness: NOP slots carry no payload, op indices are in
  range (SCHED009).

``tables.send_slot`` is read as it stands when the check runs. One
diagnostic is emitted per code, carrying the first violation plus the
total count. :func:`raise_legacy` raises ``AssertionError`` with the
message of the highest-priority diagnostic (``LEGACY_PRIORITY``), as
the scheduler's ``validate_schedule`` always did.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from repro_torch.analysis.diagnostics import (Diagnostic, Location, Severity,
                                        register_code)

if TYPE_CHECKING:                      # runtime import stays lazy/cheap
    from repro_torch.core.graph import SNNGraph
    from repro_torch.core.scheduling.tables import OpTables

NOP = -1                               # mirrors scheduling.tables.NOP

SCHED001 = register_code("SCHED001", "op count != synapse count")
SCHED002 = register_code("SCHED002", "op multiset != synapse multiset")
SCHED003 = register_code(
    "SCHED003", "Merge-Tree alignment: Post-End op outside its send slot")
SCHED004 = register_code("SCHED004", "duplicate Post-End per (SPU, post)")
SCHED005 = register_code("SCHED005", "missing Post-End for a (SPU, post)")
SCHED006 = register_code("SCHED006", "op scheduled after its send slot")
SCHED007 = register_code(
    "SCHED007", "Pre-End flag not on the last (SPU, pre) reference")
SCHED008 = register_code(
    "SCHED008", "send-slot collision: two posts share one slot")
SCHED009 = register_code(
    "SCHED009", "malformed op slot (NOP payload or out-of-range index)")

# the order the legacy validator checked invariants in; raise_legacy
# surfaces the first diagnostic under this priority so assertion
# messages stay pinned bit-for-bit
LEGACY_PRIORITY = [SCHED001, SCHED002, SCHED003, SCHED004, SCHED005,
                   SCHED006, SCHED007, SCHED008, SCHED009]


def _diag(code: str, message: str, count: int = 1,
          hint: str = "", **loc: Any) -> Diagnostic:
    return Diagnostic(code=code, severity=Severity.ERROR, message=message,
                      location=Location(**loc), hint=hint, count=count)


def check_schedule(g: "SNNGraph", tables: "OpTables") -> list[Diagnostic]:
    """All schedule-legality diagnostics for (graph, tables).

    Pure and total: never raises on corrupt inputs — malformed values
    become SCHED009 diagnostics and are masked out of the dependent
    checks. Returns ``[]`` exactly when the legacy validator accepted.
    """
    out: list[Diagnostic] = []
    n = int(g.n_neurons)
    valid = tables.pre != NOP
    spu_i, slot_i = np.nonzero(valid)           # row-major: (spu, t) order
    pre_v = tables.pre[spu_i, slot_i]
    post_v = tables.post[spu_i, slot_i]
    w_v = tables.weight[spu_i, slot_i]

    # -- SCHED009: well-formedness ------------------------------------------
    nop_payload = (~valid) & ((tables.post != NOP) | (tables.weight != 0)
                              | tables.pre_end | tables.post_end)
    bad_idx = ((pre_v < 0) | (pre_v >= n)
               | (post_v < g.n_inputs) | (post_v >= n))
    n_bad = int(nop_payload.sum()) + int(bad_idx.sum())
    if n_bad:
        if nop_payload.any():
            s, t = (int(x) for x in np.argwhere(nop_payload)[0])
            msg = f"NOP slot carries payload on SPU {s} at slot {t}"
        else:
            i = int(np.argmax(bad_idx))
            s, t = int(spu_i[i]), int(slot_i[i])
            msg = (f"op index out of range on SPU {s} at slot {t} "
                   f"(pre={int(pre_v[i])}, post={int(post_v[i])}, "
                   f"n_neurons={n})")
        out.append(_diag(SCHED009, msg, count=n_bad, spu=s, slot=t,
                         hint="artifact arrays are corrupt; recompile"))
    ok = ~bad_idx                                # mask for index-safe checks

    # -- SCHED001: every synapse appears exactly once -----------------------
    n_placed = int(valid.sum())
    if n_placed != g.n_synapses:
        out.append(_diag(
            SCHED001, f"{n_placed} ops != {g.n_synapses} synapses",
            hint="ops were dropped or invented; re-run schedule_pass"))

    # -- SCHED002: op multiset == synapse multiset --------------------------
    have = np.lexsort((w_v, post_v, pre_v))
    want = np.lexsort((g.weight, g.post, g.pre))
    if not (len(have) == len(want)
            and np.array_equal(pre_v[have], g.pre[want])
            and np.array_equal(post_v[have], g.post[want])
            and np.array_equal(w_v[have], g.weight[want])):
        msg = "op multiset != synapse multiset"
        kw: dict[str, int] = {}
        if len(have) == len(want) and len(have):
            d = ((pre_v[have] != g.pre[want]) | (post_v[have] != g.post[want])
                 | (w_v[have] != g.weight[want]))
            j = int(np.argmax(d))
            i = int(have[j])
            kw = {"spu": int(spu_i[i]), "slot": int(slot_i[i]),
                  "pre": int(pre_v[i]), "post": int(post_v[i])}
            msg += (f" (first diverging op pre={int(pre_v[i])} "
                    f"post={int(post_v[i])} weight={int(w_v[i])} on SPU "
                    f"{kw['spu']} slot {kw['slot']})")
        out.append(_diag(SCHED002, msg,
                         hint="table payload diverged from the graph; "
                              "recompile", **kw))

    # send slot per post as a dense lookup table (missing posts read -1)
    ss = np.full(n, -1, np.int64)
    for pq, t in tables.send_slot.items():
        if 0 <= int(pq) < n:
            ss[int(pq)] = int(t)

    # -- SCHED003: merge alignment ------------------------------------------
    pe_spu, pe_slot = np.nonzero(tables.post_end)
    pe_post = tables.post[pe_spu, pe_slot]
    pe_ok = (pe_post >= 0) & (pe_post < n)
    bad = np.zeros(len(pe_post), bool)
    bad[pe_ok] = ss[pe_post[pe_ok]] != pe_slot[pe_ok]
    if bad.any():
        i = int(np.argmax(bad))                  # first violation, (spu, t)
        out.append(_diag(
            SCHED003,
            f"post {int(pe_post[i])} sent at {int(pe_slot[i])} "
            f"!= slot {int(ss[int(pe_post[i])])}",
            count=int(bad.sum()), spu=int(pe_spu[i]),
            slot=int(pe_slot[i]), post=int(pe_post[i]),
            hint="send_slot and Post-End flags disagree; the Merge Tree "
                 "would commit this post in the wrong slot"))

    # -- SCHED004/005: exactly one Post-End per (spu, post with ops) --------
    pe_key = pe_spu[pe_ok] * n + pe_post[pe_ok]
    op_key = spu_i[ok] * n + post_v[ok]
    uniq_pe, pe_counts = np.unique(pe_key, return_counts=True)
    dup = pe_counts > 1
    if dup.any():
        k = int(uniq_pe[np.argmax(dup)])
        out.append(_diag(
            SCHED004,
            f"duplicate post_end in one SPU "
            f"(post {k % n} flagged {int(pe_counts[np.argmax(dup)])}x "
            f"on SPU {k // n})",
            count=int(dup.sum()), spu=k // n, post=k % n,
            hint="a post would be committed twice by one SPU"))
    uniq_op = np.unique(op_key)
    if not np.array_equal(uniq_pe, uniq_op):
        missing = np.setdiff1d(uniq_op, uniq_pe)
        extra = np.setdiff1d(uniq_pe, uniq_op)
        k = int(missing[0]) if len(missing) else int(extra[0])
        what = "no ops" if not len(missing) else "no Post-End"
        out.append(_diag(
            SCHED005,
            f"missing post_end (post {k % n} on SPU {k // n} has {what})",
            count=int(len(missing) + len(extra)), spu=k // n, post=k % n,
            hint="every (SPU, post) group must end in exactly one "
                 "Post-End op"))

    # -- SCHED006: all ops of (spu, post) at slots <= send slot -------------
    late = np.zeros(len(post_v), bool)
    late[ok] = slot_i[ok] > ss[post_v[ok]]
    if late.any():
        i = int(np.argmax(late))
        out.append(_diag(
            SCHED006,
            f"op of post {int(post_v[i])} on SPU {int(spu_i[i])} at slot "
            f"{int(slot_i[i])} after its send slot {int(ss[post_v[i]])}",
            count=int(late.sum()), spu=int(spu_i[i]), slot=int(slot_i[i]),
            post=int(post_v[i]),
            hint="the accumulated current would arrive after the Neuron "
                 "Unit already committed this post"))

    # -- SCHED007: pre_end exactly on last reference per (spu, pre) ---------
    key = spu_i[ok] * n + np.clip(pre_v[ok], 0, n - 1)
    order = np.lexsort((slot_i[ok], key))
    k_sorted, s_sorted = key[order], slot_i[ok][order]
    is_last = np.r_[k_sorted[1:] != k_sorted[:-1],
                    np.ones(min(len(key), 1), bool)]
    fe_spu, fe_slot = np.nonzero(tables.pre_end)
    fe_pre = tables.pre[fe_spu, fe_slot]
    fe_ok = (fe_pre >= 0) & (fe_pre < n)
    fkey = fe_spu[fe_ok] * n + fe_pre[fe_ok]
    forder = np.lexsort((fe_slot[fe_ok], fkey))
    fk, fs = fkey[forder], fe_slot[fe_ok][forder]
    f_last = np.r_[fk[1:] != fk[:-1], np.ones(min(len(fk), 1), bool)]
    if not (np.array_equal(fk[f_last], k_sorted[is_last])
            and np.array_equal(fs[f_last], s_sorted[is_last])):
        want_pairs = set(zip(k_sorted[is_last].tolist(),
                             s_sorted[is_last].tolist()))
        got_pairs = set(zip(fk[f_last].tolist(), fs[f_last].tolist()))
        diff = sorted(want_pairs ^ got_pairs)
        k2, t2 = (diff[0] if diff else (0, 0))
        out.append(_diag(
            SCHED007,
            f"pre_end flags wrong (pre {int(k2) % n} on SPU {int(k2) // n} "
            f"around slot {int(t2)})",
            count=max(len(diff), 1), spu=int(k2) // n, slot=int(t2),
            pre=int(k2) % n,
            hint="Pre-End must clear the Spike Memory bit exactly at the "
                 "last reference"))

    # -- SCHED008: one send per slot (Merge-Tree occupancy) -----------------
    slots = np.asarray(sorted(int(t) for t in tables.send_slot.values()),
                       np.int64)
    coll = np.flatnonzero(slots[1:] == slots[:-1]) if len(slots) else \
        np.zeros(0, np.int64)
    if len(coll):
        t = int(slots[int(coll[0])])
        posts = sorted(int(p) for p, tt in tables.send_slot.items()
                       if int(tt) == t)
        out.append(_diag(
            SCHED008,
            f"send-slot collision: posts {posts} all sent at slot {t}",
            count=int(len(coll)), slot=t, post=posts[0],
            hint="the Merge Tree would fold distinct posts into one "
                 "Neuron-Unit commit; reschedule"))

    return out


def raise_legacy(diags: list[Diagnostic]) -> None:
    """Compat shim: raise ``AssertionError`` for the highest-priority
    diagnostic under the legacy check order (message parity with the
    pre-framework ``validate_schedule`` asserts), or return silently."""
    if not diags:
        return
    rank = {c: i for i, c in enumerate(LEGACY_PRIORITY)}
    first = min(diags, key=lambda d: (rank.get(d.code, len(rank))))
    raise AssertionError(first.message)
