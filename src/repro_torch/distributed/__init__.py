"""Port of :mod:`repro.distributed`: the sharding rules on a torch
``DeviceMesh`` (``sharding``), int8 gradient compression with error
feedback (``compression``), checkpoints, elastic re-meshing
(``elastic``), the straggler monitor and the step journal; the
reference's ``__all__`` whole. ``tensor_parallel`` is the port's own:
how the ruled steps compute each layer in shards, which the reference's
GSPMD derives from its partition specs."""
from repro_torch.distributed.sharding import (LOGICAL_RULES_1POD,
                                              LOGICAL_RULES_2POD, MeshRules,
                                              input_shardings,
                                              logical_constraint, mesh_rules,
                                              param_pspec, param_shardings)
from repro_torch.distributed.compression import (CompressedGrads,
                                                 compress_int8,
                                                 compressed_allreduce_spec,
                                                 decompress_int8)
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step, load_checkpoint,
                                                save_checkpoint)
from repro_torch.distributed.elastic import replan_mesh, reshard_tree
from repro_torch.distributed.straggler import StepJournal, StragglerMonitor

__all__ = [
    "LOGICAL_RULES_1POD", "LOGICAL_RULES_2POD", "MeshRules",
    "logical_constraint", "mesh_rules", "param_pspec", "param_shardings",
    "input_shardings", "compress_int8", "decompress_int8", "CompressedGrads",
    "compressed_allreduce_spec", "save_checkpoint", "load_checkpoint",
    "latest_step", "CheckpointManager", "replan_mesh", "reshard_tree",
    "StragglerMonitor", "StepJournal",
]
