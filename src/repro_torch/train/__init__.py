"""Port of :mod:`repro.train`: the LM train, prefill and serve steps."""
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     make_prefill_step, make_serve_step,
                                     make_train_step)

__all__ = ["TrainHParams", "init_opt_state", "make_train_step",
           "make_prefill_step", "make_serve_step"]
