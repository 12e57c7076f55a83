"""Logical-axis sharding rules (MaxText-style) on a torch ``DeviceMesh``;
port of ``repro/distributed/sharding.py``.

Model code never names mesh axes. It tags activations with LOGICAL axis
names (``logical_constraint(x, "batch", "seq", None)``), and the
parameter tree is mapped to partition specs by path-pattern RULES. A
``mesh_rules`` context binds logical names to physical mesh axes; outside
any context every constraint is a no-op, so the single-device tests run
the same model code.

Physical meshes (``launch/mesh.py``):
  single-pod  (16, 16)      axes ('data', 'model')
  multi-pod   (2, 16, 16)   axes ('pod', 'data', 'model')

Logical -> physical (DESIGN.md §4):
  batch   -> ('pod', 'data')   activations' batch dim (DP)
  fsdp    -> 'data'            parameter / optimizer-state sharding (ZeRO-3)
  tensor  -> 'model'           TP: heads / mlp / vocab
  expert  -> 'model'           EP: the MoE expert dim
  seq     -> None

What the port uses in place of JAX's types:

* a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (axis names
  are its ``mesh_dim_names``) or an :class:`AbstractMesh`, axis names
  and sizes with no device (the production meshes have 256 and 512
  cards, which ``launch/specs.py`` lays out without having them);
* a partition spec is a tuple with one entry per tensor dim: ``None``,
  a physical axis name, or a tuple of names (the reference's
  ``PartitionSpec``; an empty tuple replicates, as ``P()`` does);
* :class:`NamedSharding` is the pair (mesh, spec). On a ``DeviceMesh``
  its :attr:`~NamedSharding.placements` are DTensor placements: one
  ``Shard(dim)`` for each mesh dim named in ``spec[dim]``, ``Replicate()``
  for the rest. DTensor orders the shards of one dim by mesh dim (the
  first mesh dim outermost); a tuple axis in another order, such as
  ``tp_ep_full``'s ``("model", "data")``, gives the same shard shapes
  with another assignment of chunks to ranks.

``logical_constraint`` redistributes a DTensor to the constrained
placements; a plain tensor comes back unchanged after the reference's
rank check. The port's ruled steps (``train/steps.py``) run the model on
each rank's batch shard with local tensors, so the six constraints of
``models/model.py`` cost a rank check there: what GSPMD derives from
them and from ``param_pspec`` (each layer in shards over ``tensor`` and
``expert``, a train step's sequences in segments over ``seq``) the port
computes by hand in ``tensor_parallel.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch

PartitionSpec = tuple


# ---------------------------------------------------------------------------
# Meshes and shardings
# ---------------------------------------------------------------------------


class AbstractMesh:
    """A mesh of axis names and sizes with no device (the counterpart of
    ``jax.sharding.AbstractMesh``): what a layout needs, for a mesh no
    machine here has."""

    def __init__(self, axis_sizes: tuple, axis_names: tuple):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for axes {axis_names}")
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axis_names(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`
    (``jax.sharding.Mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(ax) -> tuple:
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def placements(mesh, spec: PartitionSpec) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` where the dim's name is in ``spec[d]``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_axis_names(mesh)]
    index = {n: i for i, n in enumerate(mesh_axis_names(mesh))}
    for d, ax in enumerate(spec):
        for name in _names(ax):
            out[index[name]] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec = ()

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: tuple) -> tuple:
        """One device's block of a global ``shape``."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, ax in zip(shape, spec):
            n = _axis_size(self.mesh, ax)
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {ax} ({n})")
            out.append(dim // n)
        return tuple(out)


# ---------------------------------------------------------------------------
# Logical-axis binding
# ---------------------------------------------------------------------------


class MeshRules:
    """Binds logical axis names to physical mesh axes for one mesh."""

    def __init__(self, mesh, rules: dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def to_pspec(self, logical: tuple) -> PartitionSpec:
        phys = []
        used: set[str] = set()
        for ax in logical:
            m = self.rules.get(ax) if ax is not None else None
            # one physical axis may appear at most once in a spec
            if m is None:
                phys.append(None)
            elif isinstance(m, tuple):
                keep = tuple(a for a in m if a not in used)
                used.update(keep)
                # a tuple of one is its name, as PartitionSpec has it
                phys.append(keep if len(keep) > 1 else
                            keep[0] if keep else None)
            else:
                if m in used:
                    phys.append(None)
                else:
                    used.add(m)
                    phys.append(m)
        return tuple(phys)

    def sharding(self, logical: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, self.to_pspec(logical))


LOGICAL_RULES_1POD = {
    "batch": "data",
    "fsdp": "data",
    "tensor": "model",
    "expert": "model",
    "seq": None,
    "kv_heads": "model",     # only applied when divisible (see param rules)
}

LOGICAL_RULES_2POD = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "tensor": "model",
    "expert": "model",
    "seq": None,
    "kv_heads": "model",
}


_STATE = threading.local()


def _current() -> Optional[MeshRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def mesh_rules(rules: Optional[MeshRules]):
    """Activate the logical->physical binding for model code in this
    block (per thread; nested blocks restore the outer binding)."""
    prev = _current()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def _is_dtensor(x) -> bool:
    # a DTensor exists only once its module is imported: the model's
    # import does not pay for torch.distributed.tensor
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def logical_constraint(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axis
    names: a no-op when no ``mesh_rules`` context is active. Under one,
    a DTensor is redistributed to the placements of the axes whose shard
    count divides its dim (never an indivisible one); a plain tensor
    comes back unchanged."""
    r = _current()
    if r is None:
        return x
    assert len(axes) == x.ndim, (axes, tuple(x.shape))
    spec = []
    for dim, ax in zip(x.shape, r.to_pspec(tuple(axes))):
        size = _axis_size(r.mesh, ax)
        spec.append(ax if (ax is not None and dim % size == 0) else None)
    if _is_dtensor(x) and not isinstance(r.mesh, AbstractMesh):
        return x.redistribute(r.mesh, placements(r.mesh, tuple(spec)))
    return x


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


# ---------------------------------------------------------------------------
# Parameter-tree sharding rules (path-pattern based)
# ---------------------------------------------------------------------------

# Each entry: (path regex, logical axes per dim). First match wins. Paths
# are '/'-joined tree keys, e.g. "layers/attn/wq". Rank must match.
PARAM_RULES: list[tuple[str, tuple]] = [
    # --- embeddings / heads -------------------------------------------------
    (r"embed_codebooks$", ("tensor", None, "fsdp")),     # [K, V, D] musicgen
    (r"lm_heads$", (None, "fsdp", "tensor")),            # [K, D, V] musicgen
    (r"embed$", ("tensor", "fsdp")),                     # [V, D] vocab-parallel
    (r"lm_head$", ("fsdp", "tensor")),                   # [D, V]
    # --- attention (stacked [L, ...] — leading layer axis unsharded) -------
    (r"attn/w[qkv]$", (None, "fsdp", "tensor")),
    (r"attn/wo$", (None, "tensor", "fsdp")),
    (r"attn/b[qkv]$", (None, "tensor")),
    (r"shared_attn/w[qkv]$", ("fsdp", "tensor")),        # zamba2: unstacked
    (r"shared_attn/wo$", ("tensor", "fsdp")),
    (r"shared_attn/b[qkv]$", ("tensor",)),
    # --- MLA ---------------------------------------------------------------
    (r"attn/wq_a$", (None, "fsdp", "tensor")),
    (r"attn/wq_b$", (None, "fsdp", "tensor")),
    (r"attn/wkv_a$", (None, "fsdp", "tensor")),
    (r"attn/wkv_b$", (None, "fsdp", "tensor")),
    # --- dense MLP ----------------------------------------------------------
    (r"mlp/w_(gate|up)$", (None, "fsdp", "tensor")),
    (r"mlp/w_down$", (None, "tensor", "fsdp")),
    (r"shared_mlp/w_(gate|up)$", ("fsdp", "tensor")),    # zamba2 shared block
    (r"shared_mlp/w_down$", ("tensor", "fsdp")),
    # --- MoE ----------------------------------------------------------------
    (r"moe/router$", (None, "fsdp", None)),
    (r"moe/w_(gate|up)$", (None, "expert", "fsdp", None)),   # [L, E, D, F]
    (r"moe/w_down$", (None, "expert", None, "fsdp")),        # [L, E, F, D]
    (r"moe/shared/w_(gate|up)$", (None, "fsdp", "tensor")),
    (r"moe/shared/w_down$", (None, "tensor", "fsdp")),
    # --- RWKV-6 --------------------------------------------------------------
    (r"time_mix/w[rkvg]$", (None, "fsdp", "tensor")),
    (r"time_mix/wo$", (None, "tensor", "fsdp")),
    (r"time_mix/u$", (None, "tensor", None)),            # [L, H, N]
    (r"time_mix/lora_w1$", (None, "fsdp", None)),
    (r"time_mix/lora_w2$", (None, None, None, "fsdp")),
    (r"time_mix/w1$", (None, "fsdp", None)),
    (r"time_mix/w2$", (None, None, "fsdp")),
    (r"channel_mix/wk$", (None, "fsdp", "tensor")),
    (r"channel_mix/wv$", (None, "tensor", "fsdp")),
    (r"channel_mix/wr$", (None, "fsdp", "tensor")),
    # --- Mamba2 ---------------------------------------------------------------
    (r"in_proj$", (None, "fsdp", "tensor")),
    (r"out_proj$", (None, "tensor", "fsdp")),
    (r"conv_w$", (None, None, "tensor")),
    (r"conv_b$", (None, "tensor")),
    (r"(a_log|dt_bias|d_skip)$", (None, "tensor")),
    (r"shared_attn_group/.*", None),                     # handled by attn rules
]

# 1-D / small tensors (norm scales, biases, mu vectors) -> replicated.


def _path_str(path) -> str:
    """'/'-joined keys of a tree path (dict keys, list indices, field
    names)."""
    return "/".join(str(k) for k in path)


def param_pspec(path: str, shape: tuple, rules: MeshRules) -> PartitionSpec:
    """Partition spec for one parameter by path pattern + divisibility."""
    for pat, logical in PARAM_RULES:
        if logical is None:
            continue
        if re.search(pat, path):
            if len(logical) == len(shape):
                spec = []
                for dim, ax in zip(shape, rules.to_pspec(logical)):
                    size = _axis_size(rules.mesh, ax)
                    spec.append(ax if dim % size == 0 else None)
                return tuple(spec)
            # rank mismatch (e.g. unstacked variant): try trailing alignment
            if len(logical) == len(shape) + 1 and logical[0] is None:
                spec = []
                for dim, ax in zip(shape,
                                   rules.to_pspec(tuple(logical[1:]))):
                    size = _axis_size(rules.mesh, ax)
                    spec.append(ax if dim % size == 0 else None)
                return tuple(spec)
    # default: FSDP-shard the largest divisible dim of big tensors
    if shape and max(shape) >= 1024:
        best, best_dim = None, 0
        for i, dim in enumerate(shape):
            size = _axis_size(rules.mesh, rules.rules.get("fsdp"))
            if dim % size == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            spec = [None] * len(shape)
            spec[best] = rules.rules.get("fsdp")
            return tuple(spec)
    return ()


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` on every leaf of nested dicts,
    lists, tuples and NamedTuples (and the matching leaves of ``rest``),
    keeping the structure; a path is the tuple of keys, indices and field
    names, and ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        kids = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (k,))
                for i, (k, v) in enumerate(zip(keys, tree))]
        if isinstance(tree, list):
            return kids
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """:func:`tree_map_with_path` without the path."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def flat_tree(tree) -> dict:
    """{path: leaf} of a tree, in its order (``{}`` for None)."""
    out: dict = {}
    tree_map_with_path(out.__setitem__, tree)
    return out


def gather_tree(tree):
    """Every DTensor leaf of a tree gathered into a plain tensor (a
    collective: every rank of its mesh calls it)."""
    return tree_map_with_path(
        lambda _, t: t.full_tensor() if _is_dtensor(t) else t, tree)


def param_shardings(params_shape_tree, rules: MeshRules):
    """A :class:`NamedSharding` tree matching a params tree (tensors,
    meta tensors or anything with ``.shape``; an ``int`` is a 0-d leaf)."""
    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        return NamedSharding(rules.mesh,
                             param_pspec(_path_str(path), shape, rules))
    return tree_map_with_path(one, params_shape_tree)


def input_shardings(batch_shape_tree, rules: MeshRules,
                    batch_axes: Optional[dict] = None):
    """Shard every input leaf on its batch dim (default dim 0).

    batch_axes: optional {path_suffix: dim} override (e.g. positions
    [3, B, S] carries the batch on dim 1).
    """
    batch_axes = batch_axes or {}

    def one(path, leaf):
        ps = _path_str(path)
        dim = 0
        for suffix, d in batch_axes.items():
            if ps.endswith(suffix):
                dim = d
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        ax = rules.rules.get("batch")
        if shape and shape[dim] % _axis_size(rules.mesh, ax) == 0:
            spec[dim] = ax
        return NamedSharding(rules.mesh, tuple(spec))
    return tree_map_with_path(one, batch_shape_tree)


# ---------------------------------------------------------------------------
# The ruled train step's batch split (the port's own; see train/steps.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """The port's ruled train step runs the plain model on each rank's
    shard of the batch; ``dims`` are the ``DeviceMesh`` dims that split
    it (mesh order). GSPMD computes the reference's batch-global
    quantities by itself; the model reaches them through this: a sum
    over the shards, and the whole batch gathered where a computation
    spans shards (an MoE routing group wider than one shard).

    ``seq_dims``: the mesh dims that split each sequence as well (the
    ``seq`` rule's, ``tensor_parallel.Plan.seq``), each rank then holding
    its contiguous ``segment`` of tokens at :attr:`offset`; empty where
    the sequences are whole."""
    mesh: Any
    dims: tuple = ()
    seq_dims: tuple = ()
    segment: int = 0

    @property
    def n(self) -> int:
        """How many shards the batch is split into."""
        return _axis_size(self.mesh, self.dims) if self.dims else 1

    def _index(self, dims: tuple) -> int:
        coord = dict(zip(mesh_axis_names(self.mesh),
                         self.mesh.get_coordinate()))
        i = 0
        for d in dims:
            i = i * mesh_shape(self.mesh)[d] + coord[d]
        return i

    @property
    def index(self) -> int:
        """This rank's shard: DTensor's chunk order (the first mesh dim
        outermost)."""
        return self._index(self.dims)

    @property
    def seq_n(self) -> int:
        """How many segments each sequence is split into."""
        return _axis_size(self.mesh, self.seq_dims) if self.seq_dims else 1

    @property
    def offset(self) -> int:
        """The position of this rank's first token in its sequence."""
        return self._index(self.seq_dims) * self.segment

    def tokens(self) -> "BatchSplit":
        """The split of the batch's tokens: its rows over ``dims`` and its
        sequences' segments over ``seq_dims``, as one split of the batch
        (mesh order) whose :meth:`sum` and :attr:`n` count every shard
        of tokens (MoE routing groups that lie within a segment)."""
        both = set(self.dims) | set(self.seq_dims)
        return BatchSplit(self.mesh, tuple(n for n in mesh_axis_names(
            self.mesh) if n in both))

    def _placements(self, on_split, off_split) -> list:
        return [on_split if n in self.dims else off_split
                for n in mesh_axis_names(self.mesh)]

    def sum(self, t):
        """``t`` summed over the shards (no gradient)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        with torch.no_grad():
            return DTensor.from_local(t, self.mesh, self._placements(
                Partial(), Replicate())).full_tensor()

    def gather(self, x):
        """The shards' ``x`` concatenated on dim 0, in shard order; the
        gradient of each shard's rows is summed over the ranks."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        d = DTensor.from_local(x, self.mesh,
                               self._placements(Shard(0), Replicate()))
        return d.full_tensor(
            grad_placements=self._placements(Partial(), Replicate()))

    def local(self, full):
        """This rank's rows of a gathered ``full`` (dim 0)."""
        rows = full.shape[0] // self.n
        return full.narrow(0, self.index * rows, rows)


def current_split() -> Optional[BatchSplit]:
    """The active :func:`batch_split`, or None."""
    return getattr(_STATE, "split", None)


@contextlib.contextmanager
def batch_split(split: Optional[BatchSplit]):
    """Model code in this block sees this rank's batch shard."""
    prev = current_split()
    _STATE.split = split
    try:
        yield split
    finally:
        _STATE.split = prev
