"""Port of :mod:`repro.optimizer`: Adam on dicts of tensors."""
from repro_torch.optimizer.adam import (AdamConfig, AdamState, adam_init,
                                        adam_update)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update"]
