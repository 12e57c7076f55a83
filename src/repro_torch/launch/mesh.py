"""Production mesh definitions and the process group behind a real mesh;
port of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no
device and no process group.

* :func:`make_production_mesh` returns the device-free
  :class:`~repro_torch.distributed.sharding.AbstractMesh` (16, 16) or
  (2, 16, 16): its 256 / 512 cards exist on no machine here, and what
  reads it (``launch/specs.py``) needs axis names and sizes only;
* :func:`make_debug_mesh` and :func:`make_serving_mesh` build a
  ``DeviceMesh`` over the ranks of the process group
  :func:`init_distributed` started (one process per rank: ``torchrun``,
  or a spawned group): nccl on the card, gloo on the CPU. JAX's one
  process sees every device; torch's mesh is one rank per process.

The dry run (``launch/dryrun.py``) builds a ``DeviceMesh`` of the
production shape on a fake process group of its size, on the host.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (LOGICAL_RULES_1POD,
                                              LOGICAL_RULES_2POD,
                                              AbstractMesh, MeshRules,
                                              mesh_axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; multi_pod adds the 2-pod leading axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_rules(mesh) -> MeshRules:
    rules = LOGICAL_RULES_2POD if "pod" in mesh_axis_names(mesh) \
        else LOGICAL_RULES_1POD
    return MeshRules(mesh, rules)


def init_distributed(device: str | torch.device | None = None, *,
                     store=None, rank: int | None = None,
                     world_size: int | None = None) -> int:
    """Start the default process group if none is: nccl for the card
    (``device`` None or cuda), gloo for the CPU. Rank and world size come
    from the arguments, else from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a ``store``
    (``HashStore`` for one rank, ``FileStore``) replaces the address. On
    the card each rank takes device ``LOCAL_RANK`` (else its rank).
    Returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    cuda = device is None or torch.device(device).type == "cuda"
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1))
                  if world_size is None else world_size)
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "device=\"cpu\" to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kw = {"store": store} if store is not None else {}
    dist.init_process_group("nccl" if cuda else "gloo", rank=rank,
                            world_size=world_size, **kw)
    return world_size


def mesh_device_type() -> str:
    """The device type of the default group's meshes: cuda under nccl."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_over(shape: tuple, axes: tuple, ranks=None):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (default: the first
    ranks of the group); raises when the group has too few."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if n > len(ranks) or max(ranks[:n], default=0) >= world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return DeviceMesh(mesh_device_type(),
                      torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_debug_mesh(n_devices: int | None = None, *, model: int = 2):
    """A small (data, model) mesh over the process group's ranks, the
    single-pod production mesh's axis names."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    data = n // model
    return mesh_over((data, model), ("data", "model"))


def make_serving_mesh(n_devices: int | None = None):
    """Every rank on the ``data`` axis (``model`` 1): serving is pure data
    parallelism."""
    return make_debug_mesh(n_devices, model=1)
