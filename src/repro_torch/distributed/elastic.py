"""Elastic re-meshing: plan the mesh for a changed device count and
re-place a (checkpointed) state tree onto it; port of
``repro/distributed/elastic.py``.

After losing a pod or gaining capacity:

    1. pick the largest (pods, data, model) grid that fits the surviving
       ranks                                          -> ``replan_mesh``
    2. every rank loads the (mesh-agnostic) checkpoint
    3. each leaf is placed with the NEW shardings (every rank keeps its
       block of the global tensor)                    -> ``reshard_tree``

Checkpoints store LOGICAL (global) tensors (``checkpoint.py``), so
resharding is a placement decision alone. The planning arithmetic is
:func:`plan_mesh`, which needs no device; :func:`replan_mesh` builds the
``DeviceMesh`` over the ranks of the started process group
(``launch.mesh.init_distributed``). Left out: a torch process group
cannot drop a rank that died, so re-meshing here re-plans over live
ranks (the training CLI's straggler policy); losing a rank means
restarting the group (``torchrun``) and resuming from the checkpoint.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed.sharding import (LOGICAL_RULES_1POD,
                                              LOGICAL_RULES_2POD, MeshRules,
                                              _is_dtensor, mesh_axis_names,
                                              param_shardings,
                                              tree_map_with_path)


def plan_mesh(n_devices: int, *, model_parallel: int = 16
              ) -> tuple[tuple, tuple]:
    """(shape, axis names) of the largest (pod, data, model) grid for
    ``n_devices``.

    Keeps TP fixed (model weights are sharded to fit memory: shrinking TP
    can run out of it), gives the rest to data, and splits off a pod axis
    when the data extent is >= 32 (two racks' worth).
    """
    assert n_devices >= model_parallel, \
        f"need >= {model_parallel} devices, got {n_devices}"
    usable = (n_devices // model_parallel) * model_parallel
    data = usable // model_parallel
    if data >= 32 and data % 2 == 0:
        return (2, data // 2, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def replan_mesh(n_devices: int, *, model_parallel: int = 16, devices=None):
    """:func:`plan_mesh`'s grid as a ``DeviceMesh`` over ``devices`` (a
    list of ranks; default the group's first ``n_devices``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_over
    if devices is None:
        devices = list(range(dist.get_world_size()))[:n_devices]
    shape, axes = plan_mesh(len(devices), model_parallel=model_parallel)
    return mesh_over(shape, axes, devices[:math.prod(shape)])


def rules_for(mesh) -> MeshRules:
    rules = LOGICAL_RULES_2POD if "pod" in mesh_axis_names(mesh) \
        else LOGICAL_RULES_1POD
    return MeshRules(mesh, rules)


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def reshard_tree(tree, mesh, *, shardings=None):
    """Place a host tree (numpy arrays, tensors, DTensors of another mesh)
    onto ``mesh``: every leaf a DTensor with the standard rules'
    placements (``param_shardings`` of :func:`rules_for`), or those of
    ``shardings``. Every rank must hold the same global tree (each keeps
    its block; nothing is sent). An ``int`` leaf stays as it is."""
    from torch.distributed.tensor import distribute_tensor
    if shardings is None:
        shardings = param_shardings(tree, rules_for(mesh))
    dev = _device(mesh)

    def one(_, leaf, sh):
        if isinstance(leaf, int):
            return leaf
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        elif isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        return distribute_tensor(leaf.to(dev), mesh, sh.placements,
                                 src_data_rank=None)
    return tree_map_with_path(one, tree, shardings)
