"""Partitioning-tree geometry (paper §6.2); port of
``repro/core/mapping/tree.py``.

The binary Partitioning Tree mirrors the ME tree: M-1 probability
switches in heap order, M SPU leaves. This module owns the pure
geometry — routing synapses through the switches and the root-path /
LCA tables the rebalancing moves need — all as precomputed arrays so
the search loop never re-derives paths.

``walk`` is batched over arbitrary leading dimensions: the portfolio
search advances a whole restart population with one call on
``[R, M-1, E]`` state instead of R serial walks.
"""
from __future__ import annotations

import numpy as np


def walk(p: np.ndarray, r: np.ndarray, depth: int) -> np.ndarray:
    """Route every synapse through the tree.

    p, r: ``[..., M-1, E]`` switch probabilities and fixed draws (a
    synapse goes LEFT at a switch when R < P). Returns the leaf (SPU)
    index per synapse, ``[..., E]`` int32. Leading dimensions batch
    independent populations (restart seeds) through one call.
    """
    prefix = np.zeros(p.shape[:-2] + p.shape[-1:], np.int64)
    for d in range(depth):
        sw = ((1 << d) - 1 + prefix)[..., None, :]
        pv = np.take_along_axis(p, sw, axis=-2)[..., 0, :]
        rv = np.take_along_axis(r, sw, axis=-2)[..., 0, :]
        prefix = (prefix << 1) | (rv >= pv)
    return prefix.astype(np.int32)


def leaf_paths(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Root-to-leaf paths for all M = 2**depth leaves.

    Returns ``(switch, side)``, both ``[M, depth]``: ``switch[leaf, d]``
    is the heap index of the switch at depth d on the path to ``leaf``,
    ``side[leaf, d]`` is 0 for left, 1 for right.
    """
    m = 1 << depth
    switch = np.zeros((m, depth), np.int64)
    side = np.zeros((m, depth), np.int8)
    for leaf in range(m):
        prefix = 0
        for d in range(depth):
            s = (leaf >> (depth - 1 - d)) & 1
            switch[leaf, d] = (1 << d) - 1 + prefix
            side[leaf, d] = s
            prefix = (prefix << 1) | s
    return switch, side


def lca_depths(depth: int) -> np.ndarray:
    """``[M, M]`` table: first depth at which the root paths of two
    leaves diverge (== the depth *below* their lowest common ancestor).
    ``lca_depths(d)[a, a] == d`` (identical paths never diverge)."""
    m = 1 << depth
    bits = (np.arange(m)[:, None] >> (depth - 1 - np.arange(depth))) & 1
    diff = bits[:, None, :] != bits[None, :, :]
    return np.where(diff.any(-1), diff.argmax(-1), depth)
