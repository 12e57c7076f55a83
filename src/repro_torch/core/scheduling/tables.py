"""Operation-table containers and lowering; port of
``repro/core/scheduling/tables.py`` (numpy).

:class:`OpTables` is the mapped + scheduled program (the [M, depth]
grid a SupraSNN engine executes); :class:`LoweredProgram` is its dense
slot-major form, which the torch engine executes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import SNNGraph

NOP = -1


@dataclasses.dataclass
class OpTables:
    """The mapped + scheduled program for the whole engine."""
    depth: int                  # S_OT: operation-table depth == #slots
    # all arrays are [M, depth]; NOP slots have pre == NOP
    pre: np.ndarray             # global pre-neuron index
    post: np.ndarray            # global post-neuron index
    weight: np.ndarray          # int weight value
    pre_end: np.ndarray         # bool
    post_end: np.ndarray        # bool
    send_slot: dict             # post global idx -> slot
    send_order: list            # posts in send order
    assign: np.ndarray          # [E] synapse -> SPU (the partition)

    @property
    def n_spus(self) -> int:
        return self.pre.shape[0]

    @classmethod
    def from_dense(cls, pre: np.ndarray, post: np.ndarray, weight: np.ndarray,
                   pre_end: np.ndarray, post_end: np.ndarray,
                   assign: np.ndarray) -> "OpTables":
        """Rebuild OpTables from the dense arrays alone.

        ``send_slot``/``send_order`` are derived: every Post-End op of
        post p sits in p's send slot, so the flags determine both.
        """
        spus, slots = np.nonzero(post_end)
        send_slot = {int(p): int(t)
                     for p, t in zip(post[spus, slots], slots)}
        send_order = sorted(send_slot, key=send_slot.__getitem__)
        return cls(int(pre.shape[1]), pre, post, weight, pre_end, post_end,
                   send_slot, send_order, assign)


@dataclasses.dataclass(frozen=True)
class LoweredProgram:
    """Dense array form of a scheduled program, ready for execution.

    The (SPU, slot) grid is flattened into slot-major op streams (all
    SPUs of slot 0, then slot 1, ...), plus the MC-tree routing bitmap.
    """
    n_inputs: int
    n_neurons: int
    n_internal: int
    n_spus: int
    depth: int                  # S_OT of the source tables
    # flattened non-NOP ops, slot-major; all arrays are [n_ops]
    op_spu: np.ndarray          # int32 SPU executing the op
    op_slot: np.ndarray         # int32 OT slot of the op
    op_pre: np.ndarray          # int32 global pre-neuron index
    op_post_local: np.ndarray   # int32 LOCAL post index (global - n_inputs)
    op_weight: np.ndarray       # int32 weight
    op_pre_end: np.ndarray      # bool Pre-End flag
    op_post_end: np.ndarray     # bool Post-End flag
    # MC-tree routing bitstrings: routing[q, i] == SPU i holds a synapse of q
    routing: np.ndarray         # [n_neurons, n_spus] bool

    @property
    def n_ops(self) -> int:
        return int(self.op_pre.shape[0])


def lower_tables(g: SNNGraph, tables: OpTables) -> LoweredProgram:
    """Lower scheduled OpTables into the dense :class:`LoweredProgram`."""
    m, depth = tables.pre.shape
    spu, slot = np.nonzero(tables.pre != NOP)
    order = np.lexsort((spu, slot))          # slot-major commit order
    spu, slot = spu[order], slot[order]

    routing = np.zeros((g.n_neurons, m), bool)
    routing[g.pre, tables.assign] = True

    return LoweredProgram(
        n_inputs=g.n_inputs,
        n_neurons=g.n_neurons,
        n_internal=g.n_internal,
        n_spus=m,
        depth=depth,
        op_spu=spu.astype(np.int32),
        op_slot=slot.astype(np.int32),
        op_pre=tables.pre[spu, slot].astype(np.int32),
        op_post_local=(tables.post[spu, slot] - g.n_inputs).astype(np.int32),
        op_weight=tables.weight[spu, slot].astype(np.int32),
        op_pre_end=tables.pre_end[spu, slot].copy(),
        op_post_end=tables.post_end[spu, slot].copy(),
        routing=routing,
    )
