"""Port of :mod:`repro.distributed`: checkpoints, the straggler monitor
and the step journal. Sharding rules, gradient compression and elastic
re-meshing need a device mesh and are not ported yet (ROADMAP Queue A
item 9)."""
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step, load_checkpoint,
                                                save_checkpoint)
from repro_torch.distributed.straggler import StepJournal, StragglerMonitor

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager", "StragglerMonitor", "StepJournal"]
