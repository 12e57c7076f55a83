"""Stand-ins for every model input, parameter and state leaf: global
shape, dtype, sharding and per-device shard shape, with no allocation;
port of ``repro/launch/specs.py``.

For a training cell the inputs are {tokens, labels(, positions)}; for
prefill {tokens(, positions)}; for decode (tokens [B, 1], decode state)
with K/V capacity = ``shape.seq_len``. The reference builds
``jax.ShapeDtypeStruct`` stand-ins by ``jax.eval_shape``; the port builds
:class:`Spec` stand-ins from the real initializers run on the ``meta``
device (``init_model``, ``init_decode_state``, ``init_opt_state``), so
the trees are exactly those the launcher would allocate. The meshes are
usually :func:`~repro_torch.launch.mesh.make_production_mesh`'s
device-free ones. The dry run (``launch/dryrun.py``) places these
stand-ins as meta DTensors and runs each cell's step on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import (MeshRules, NamedSharding,
                                              _axis_size, input_shardings,
                                              param_shardings, tree_map)
from repro_torch.models import model as M
from repro_torch.optimizer.adam import AdamState
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     opt_state_shardings)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One leaf's stand-in (``jax.ShapeDtypeStruct``): its global shape
    and dtype, and its sharding (None: one device holds it whole)."""
    shape: tuple
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None

    @property
    def shard_shape(self) -> tuple:
        """The block one device holds."""
        if self.sharding is None:
            return self.shape
        return self.sharding.shard_shape(self.shape)


def _sds(leaf, sharding=None) -> Spec:
    return Spec(tuple(leaf.shape), leaf.dtype, sharding)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                rules: Optional[MeshRules]) -> dict:
    """Input specs for train / prefill cells."""
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    batch = {"tokens": Spec(tok_shape, torch.int32)}
    if shape.kind == "train":
        batch["labels"] = Spec(tok_shape, torch.int32)
    if cfg.mrope_sections:
        batch["positions"] = Spec((3, b, s), torch.int32)
    if rules is not None:
        sh = input_shardings(batch, rules, batch_axes={"positions": 1})
        batch = tree_map(_sds, batch, sh)
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeSpec,
                 rules: Optional[MeshRules],
                 unrolled: bool = False) -> tuple:
    """(tokens, state) specs for a serve-step cell: one new token against
    a cache of capacity seq_len."""
    b, cap = shape.global_batch, shape.seq_len
    tok_shape = (b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1)
    state = tree_map(_sds, M.init_decode_state(cfg, b, cap, "meta",
                                           unrolled=unrolled))
    tokens = Spec(tok_shape, torch.int32)
    if rules is not None:
        spec = ((rules.rules.get("batch"),)
                if b % _size(rules, "batch") == 0 else ())
        tokens = Spec(tok_shape, torch.int32,
                      NamedSharding(rules.mesh, spec))
        state = tree_map(lambda l: Spec(l.shape, l.dtype,
                                    _state_sharding(l, rules, b)), state)
    return tokens, state


def _size(rules: MeshRules, logical: str) -> int:
    return _axis_size(rules.mesh, rules.rules.get(logical))


def _state_sharding(leaf, rules: MeshRules, b: int) -> NamedSharding:
    """Decode-state placement heuristic.

    Batch lives at dim 1 for stacked [L, B, ...] caches, dim 0 for
    unrolled per-layer [B, ...] caches -> shard it over 'batch' when
    divisible. The dim two past batch (kv-heads of GQA caches, latent
    rank of MLA caches, head/channel dims of recurrent states) -> 'tensor'
    when divisible; when it does NOT divide (GQA with few KV heads), shard
    the CAPACITY dim (batch+1) over 'tensor' instead (flash-decode style).
    """
    shape = tuple(leaf.shape)
    spec: list = [None] * len(shape)
    bdim = 0 if (shape and shape[0] == b) else 1
    if len(shape) > bdim:
        ax = rules.rules.get("batch")
        if ax is not None and shape[bdim] % _size(rules, "batch") == 0:
            spec[bdim] = ax
    ax = rules.rules.get("tensor")
    if ax is not None and len(shape) >= bdim + 3:
        if shape[bdim + 2] % _size(rules, "tensor") == 0:
            spec[bdim + 2] = ax
        elif len(shape) >= bdim + 4 and \
                shape[bdim + 1] % _size(rules, "tensor") == 0:
            spec[bdim + 1] = ax
    return NamedSharding(rules.mesh, tuple(spec))


def model_specs(cfg: ArchConfig, rules: Optional[MeshRules],
                hp: Optional[TrainHParams] = None) -> tuple:
    """(param specs, opt-state specs) from the meta initializers."""
    pshapes = M.init_model(cfg, None, "meta")
    if rules is None:
        pspecs = tree_map(_sds, pshapes)
    else:
        pspecs = tree_map(_sds, pshapes, param_shardings(pshapes, rules))
    if hp is None:
        return pspecs, None
    oshapes = init_opt_state(pshapes, hp)
    if rules is None:
        return pspecs, AdamState(Spec((), torch.int32),
                                 *(tree_map(_sds, t) for t in oshapes[1:]))
    osh = _opt_shardings(oshapes, pshapes, rules)
    return pspecs, AdamState(Spec((), torch.int32, osh.step),
                             *(tree_map(_sds, t, sh) for t, sh in
                               zip(oshapes[1:], osh[1:])))


# the moments' layout is the ruled train step's own (train/steps.py)
_opt_shardings = opt_state_shardings
